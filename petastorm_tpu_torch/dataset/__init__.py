"""The dataset-mutation plane: generation tokens, the watch thread that diffs the piece
set of a live dataset, and deterministic mutation helpers for the chaos plane (port of
``petastorm_tpu.dataset``)."""
from petastorm_tpu_torch.dataset.watch import (  # noqa: F401
    DatasetWatcher,
    PlanDelta,
    WatchOptions,
    current_stat_token,
    generation_token,
    stamp_generation_tokens,
    tokens_match,
)

__all__ = [
    "DatasetWatcher",
    "PlanDelta",
    "WatchOptions",
    "current_stat_token",
    "generation_token",
    "stamp_generation_tokens",
    "tokens_match",
]
