"""graftlint: project-native static analysis for petastorm_tpu_torch.

The hot paths of this codebase are exactly the places generic linters go blind:
lock discipline across the executor/loader thread pools (``workers.py``,
``loader.py``), clean reader/executor shutdown, capture hazards inside
``torch.compile`` bodies and CUDA graph captures, and the Unischema field/codec
contract. ``graftlint`` is an
AST-based rule engine with four project-specific rule families:

- **concurrency** (``GL-C0xx``): shared mutable attributes written outside the
  lock that otherwise guards them; untimed blocking ``Queue.get()``/``join()``
  on stop/shutdown paths; threads started without daemon-or-join handling.
- **resource lifecycle** (``GL-L0xx``): readers/executors/loaders constructed
  but never consumed via a context manager or try/finally.
- **capture hazards** (``GL-J0xx``): host reads of device values
  (``np.*``, ``.item()``, ``.cpu()``...), Python branches on tensors, and host
  I/O inside ``torch.compile`` bodies and CUDA graph captures.
- **schema/codec contracts** (``GL-S0xx``): literal ``UnischemaField``
  declarations whose codec cannot faithfully store the declared numpy dtype.

A second, whole-program phase runs after the per-file rules over the same
parsed trees: :class:`~petastorm_tpu_torch.analysis.project.ProjectContext` resolves
lock identities and a one-hop call graph across the corpus, and the project
rules flag blocking-under-lock hangs (GL-C005) and lock-order cycles
(GL-C006) that no single file shows — the controller deadlock shape.

Entry points: the ``petastorm-tpu-torch-lint`` console script (exit 0 clean / 1 new
findings / 2 internal error), ``python -m petastorm_tpu_torch.analysis``, or
:func:`analyze_paths` programmatically. Intentional violations are suppressed
inline (``# graftlint: disable=<rule-id>``) or through the checked-in baseline
(``.graftlint-baseline.json``). Rule ids, suppression syntax and the
baseline format are those of docs/static_analysis.md.
"""
from petastorm_tpu_torch.analysis.baseline import Baseline
from petastorm_tpu_torch.analysis.engine import (
    analyze_paths,
    analyze_source,
    default_project_rules,
    default_rules,
)
from petastorm_tpu_torch.analysis.findings import Finding, Severity

__all__ = [
    "Baseline",
    "Finding",
    "Severity",
    "analyze_paths",
    "analyze_source",
    "default_project_rules",
    "default_rules",
]
