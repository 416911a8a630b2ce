"""Closed-loop pipeline control (port of ``petastorm_tpu.control``).

- :mod:`petastorm_tpu_torch.control.knobs`: :class:`Knob` and :class:`KnobSet`, the
  bounded live-retune seam over the components' ``apply_*()`` setters (the options
  structs stay immutable), and :func:`build_knobset`, the standard knobs of a running
  reader.
- :mod:`petastorm_tpu_torch.control.controller`: the :class:`Controller` policy engine
  on the time-series plane's window cadence: declarative :class:`PolicyRule` s with
  hysteresis, debounce, cooldowns, step limits, warmup, and the revert-and-freeze
  no-gain guard.

``DataLoader(controller=True, metrics=..., provenance=True)`` wires all of it.
"""
from petastorm_tpu_torch.control.controller import (  # noqa: F401
    ControlOptions,
    Controller,
    Decision,
    PolicyRule,
    WindowContext,
    default_rules,
)
from petastorm_tpu_torch.control.knobs import Knob, KnobSet, build_knobset  # noqa: F401

__all__ = ["Knob", "KnobSet", "build_knobset", "Controller", "ControlOptions",
           "Decision", "PolicyRule", "WindowContext", "default_rules"]
