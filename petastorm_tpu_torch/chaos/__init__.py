"""Chaos plane: deterministic fault injection for the read pipeline.

Port of ``petastorm_tpu.chaos``. One corrupt row group or a dead decode child must not
end a training run on the card; the recovery policy (:mod:`petastorm_tpu_torch.recovery`:
transient-IO retry, poison quarantine, the respawn budget) is what absorbs them, and
this package is what proves it: a seeded :class:`FaultPlan` of :class:`FaultRule`
evaluated at named hook sites threaded through the real seams, injecting transient and
permanent IO errors, latency, corrupted wire bytes, child kills and hangs,
deterministically. Usage::

    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule, armed

    plan = FaultPlan([
        FaultRule("reader.read", "raise_transient", nth=3, times=2),
        FaultRule("child.item", "kill", item_key="ordinal=5", times=1),
    ], seed=7)
    with armed(plan):
        ...   # run the pipeline; the recovery policy absorbs the faults

Zero overhead unarmed: every hook site is ``if chaos.ACTIVE is not None``. Arming also
exports the plan as ``PTPU_CHAOS_SPEC`` (the JAX package's name and JSON), so process
pool children spawned while armed inherit it: their in-child sites (``child.item``, and
``reader.read`` inside the child) evaluate their own copy. The armed plan is this
module's global: a plan armed in the JAX package in the same process never fires at a
port site, though a propagated ``PTPU_CHAOS_SPEC`` reaches children spawned while it is
set; arm with ``armed(...)`` so the variable goes with the block. Every injection is
counted (``ptpu_degradations_total{cause="chaos_injected"}``) and recorded into any
live flight recorder.
"""
from __future__ import annotations

import contextlib
import os

from petastorm_tpu_torch.chaos.plan import (  # noqa: F401
    ChaosError,
    FaultPlan,
    FaultRule,
    allow_kill,
    item_key,
    kill_allowed,
)

#: the armed plan, or None (the default — hook sites check exactly this)
ACTIVE = None

_ENV_SPEC = "PTPU_CHAOS_SPEC"


def arm(plan, propagate=True):
    """Arm ``plan`` process-wide. With ``propagate`` (default) the plan is
    also exported as ``PTPU_CHAOS_SPEC`` so pool children spawned from now on
    arm themselves at bootstrap. Returns the plan."""
    global ACTIVE
    ACTIVE = plan
    if propagate and plan is not None:
        os.environ[_ENV_SPEC] = plan.to_json()
    return plan


def disarm():
    """Disarm fault injection (and stop propagating to new children)."""
    global ACTIVE
    ACTIVE = None
    os.environ.pop(_ENV_SPEC, None)


@contextlib.contextmanager
def armed(plan, propagate=True):
    """``with armed(plan): ...`` — arm for the block, disarm after (even when
    the block raises, so one failed scenario cannot poison the next)."""
    arm(plan, propagate=propagate)
    try:
        yield plan
    finally:
        disarm()


def arm_from_env(in_child=False):
    """Arm from ``PTPU_CHAOS_SPEC`` when present (pool-child bootstrap; also
    how the chaos harness arms its scenario subprocesses). ``in_child=True``
    additionally opts this process into the ``kill`` action. Returns the
    armed plan or None."""
    spec = os.environ.get(_ENV_SPEC)
    if not spec:
        return None
    plan = FaultPlan.from_json(spec)
    if in_child:
        allow_kill(True)
    # never re-export: this process inherited the spec from its parent
    return arm(plan, propagate=False)
