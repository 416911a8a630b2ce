"""Benchmark harnesses of the port: the throughput tool
(:mod:`petastorm_tpu_torch.benchmark.cli`, console scripts
``petastorm-tpu-torch-throughput`` and ``petastorm-tpu-torch-bench``), the acceptance
harnesses its subcommands run, and
:mod:`petastorm_tpu_torch.benchmark.trend`, the throughput-regression gate.

Every harness takes ``--device`` (default ``cuda``) and hands it to the loaders it builds;
without a CUDA device it refuses to run unless the caller asks for the CPU
(``--device cpu``), as the port's other entry points do."""


def add_device_argument(parser):
    """The ``--device`` flag every harness takes."""
    parser.add_argument("--device", default="cuda",
                        help="the loaders' torch device (default: cuda; pass cpu to "
                             "run on the host)")


def require_device(device):
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it names a CUDA
    device and there is none (no silent fall back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "petastorm_tpu_torch.benchmark: no CUDA device. The harnesses run on the GPU "
            "unless the caller asks for the CPU (--device cpu).")
    return dev
