"""Framework exceptions (a copy of ``petastorm_tpu.errors``, cut to what the port raises)."""


class PetastormTpuError(Exception):
    """Base class for framework errors."""


class DecodeFieldError(PetastormTpuError):
    """Raised when a codec fails to decode a stored field value."""


class NoDataAvailableError(PetastormTpuError):
    """Raised when a reader has no row groups to read after sharding."""


class TimeoutWaitingForResultError(PetastormTpuError):
    """No worker produced a result within the configured timeout."""


class MetadataError(PetastormTpuError):
    """Dataset metadata missing or malformed (reference: PetastormMetadataError)."""


class PagedecCorruptError(PetastormTpuError):
    """A compressed-page pass-through decoder found a malformed page: a truncated or
    bit-flipped header, a payload running past its chunk, a codec stream that fails to
    inflate, or a dictionary index out of range. Permanent (retrying re-reads the same
    bytes), ``cause="pagedec_corrupt"``. Every decoder bounds-checks before touching
    memory, so corrupt input ends in this error, never in an out-of-bounds read."""

    cause = "pagedec_corrupt"
    permanent = True
