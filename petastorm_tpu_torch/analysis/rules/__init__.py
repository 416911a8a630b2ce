"""Rule registry: the project-specific rule families."""
from petastorm_tpu_torch.analysis.rules.concurrency import (
    BlockingTeardownRule,
    LockDisciplineRule,
    OptionsMutationRule,
    ThreadHandlingRule,
)
from petastorm_tpu_torch.analysis.rules.hotpath import WallClockDurationRule
from petastorm_tpu_torch.analysis.rules.lifecycle import ResourceLifecycleRule
from petastorm_tpu_torch.analysis.rules.observability import (
    SilentExceptionSwallowRule,
    SleepyPollLoopRule,
    UnboundedLabelRule,
    UnpairedSpanRule,
    WallClockSpanRule,
)
from petastorm_tpu_torch.analysis.rules.project_concurrency import (
    BlockingUnderLockRule,
    LockOrderCycleRule,
)
from petastorm_tpu_torch.analysis.rules.robustness import (
    StatThenOpenRule,
    UnboundedBlockingCallRule,
    UnboundedSocketRule,
)
from petastorm_tpu_torch.analysis.rules.schema import SchemaCodecContractRule
from petastorm_tpu_torch.analysis.rules.tracing import (
    HostIoInJitRule,
    NumpyInJitRule,
    TracedBranchRule,
)

#: every registered rule class, in reporting order
ALL_RULES = [
    LockDisciplineRule,
    BlockingTeardownRule,
    ThreadHandlingRule,
    OptionsMutationRule,
    ResourceLifecycleRule,
    NumpyInJitRule,
    TracedBranchRule,
    HostIoInJitRule,
    SchemaCodecContractRule,
    WallClockDurationRule,
    SilentExceptionSwallowRule,
    UnpairedSpanRule,
    SleepyPollLoopRule,
    UnboundedLabelRule,
    WallClockSpanRule,
    UnboundedBlockingCallRule,
    StatThenOpenRule,
    UnboundedSocketRule,
]

#: whole-program rules, run once over the ProjectContext after the per-file
#: phase
ALL_PROJECT_RULES = [
    BlockingUnderLockRule,
    LockOrderCycleRule,
]

__all__ = ([cls.__name__ for cls in ALL_RULES]
           + [cls.__name__ for cls in ALL_PROJECT_RULES]
           + ["ALL_RULES", "ALL_PROJECT_RULES"])
