"""The port must lint clean against its own analyzer.

The counterpart of ``test_lint_clean.py`` for ``petastorm_tpu_torch``: every rule family of
``petastorm_tpu_torch.analysis`` runs over the port's package, its tests and its examples
with no baseline at all. Each accepted violation is an inline ``disable`` that states its
reason; the deadlock rules hold on the executor and loader by construction.
"""
import glob
import os

from petastorm_tpu_torch.analysis.cli import main as lint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_paths():
    tests = sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py"))
                   + glob.glob(os.path.join(REPO_ROOT, "tests", "_torch_*.py")))
    assert tests
    return ([os.path.join(REPO_ROOT, "petastorm_tpu_torch")] + tests
            + [os.path.join(REPO_ROOT, "examples", "torch")])


def test_port_lints_clean():
    rc = lint_main(_port_paths() + ["--no-baseline"])
    assert rc == 0, (
        "petastorm-tpu-torch-lint found findings — run `petastorm-tpu-torch-lint "
        "petastorm_tpu_torch/ tests/test_torch_*.py tests/_torch_*.py examples/torch/ "
        "--no-baseline` for details and fix them, or disable inline with the reason")


def test_port_package_lints_clean_without_any_suppression_mechanism():
    rc = lint_main([os.path.join(REPO_ROOT, "petastorm_tpu_torch"), "--no-baseline"])
    assert rc == 0


def test_port_executor_loader_carry_no_deadlock_rule_suppressions():
    """GL-C005/GL-C006 must hold on the port's workers.py and loader.py without
    inline disables."""
    for name in ("workers.py", "loader.py"):
        path = os.path.join(REPO_ROOT, "petastorm_tpu_torch", name)
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        for rule in ("GL-C005", "GL-C006"):
            assert rule not in source, (
                "%s suppresses %s inline — the deadlock rules must pass on the "
                "executor/loader layer by construction" % (name, rule))
