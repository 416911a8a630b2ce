"""``python -m petastorm_tpu_torch.analysis`` — same entry as petastorm-tpu-torch-lint."""
import sys

from petastorm_tpu_torch.analysis.cli import main

if __name__ == "__main__":  # importing the module (a package walk) runs nothing
    sys.exit(main())
