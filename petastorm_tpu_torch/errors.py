"""Framework exceptions (a copy of ``petastorm_tpu.errors``, cut to what the port raises)."""

#: OSError subclasses that are real answers, not connection trouble: no retry heals a
#: missing file or a refused permission
PERMANENT_IO_ERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError, FileExistsError, InterruptedError)


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


class PieceRemovedError(FileNotFoundError):
    """A planned row group's file disappeared between planning and read (the dataset
    changed under a running reader). A ``FileNotFoundError``, so the IO retry classes it
    permanent; under ``RecoveryOptions(on_poison="quarantine")`` the item is quarantined
    with ``cause="piece_removed"`` and charged to the checkpoint watermark like any
    other skip."""


class PieceRewrittenError(PetastormTpuError):
    """A planned row group's file no longer matches the generation token stamped into
    its plan item (size, mtime or footer crc differ: the file was rewritten under a
    running reader). Never retried as transient: re-reading would deliver rows of
    another generation than the rest of the epoch. The read path drops the piece's
    footer, open handle and cache entries before raising; under the quarantine policy
    the item is quarantined with ``cause="piece_rewritten"``, and the dataset watcher
    plans the new generation into a later epoch."""


class PagedecCorruptError(PetastormTpuError):
    """A compressed-page pass-through decoder found a malformed page: a truncated or
    bit-flipped header, a payload running past its chunk, a codec stream that fails to
    inflate, or a dictionary index out of range. Permanent (retrying re-reads the same
    bytes), ``cause="pagedec_corrupt"``. Every decoder bounds-checks before touching
    memory, so corrupt input ends in this error, never in an out-of-bounds read."""

    cause = "pagedec_corrupt"
    permanent = True


class LeaseError(PetastormTpuError):
    """Broken lease discipline on a :class:`petastorm_tpu_torch.io.lease.Lease`:
    releasing past a zero refcount (double release) or retaining a lease whose buffers
    were already returned to their owner. Always a caller bug: the contract is exactly
    one release per retain."""


class LeaseRevoked(PetastormTpuError):
    """The buffers behind a lease were invalidated by their owner, e.g. a
    ``Reader.reset()`` rebuilt the process pool whose slab ring backed a still-retained
    batch. Lease-aware accessors raise this instead of returning views into recycled
    memory."""


class WorkerDiedError(PetastormTpuError, RuntimeError):
    """A pool worker process died and the respawn budget (``worker_respawns``, default
    2, or ``PTPU_WORKER_RESPAWNS``) is exhausted. Carries the original child failure as
    ``__cause__`` and ``original``."""

    def __init__(self, message, original=None):
        super().__init__(message)
        self.original = original
        if original is not None:
            self.__cause__ = original


class TransportLinkDown(ConnectionResetError):
    """A tcp transport link died mid-conversation: a socket error, a clean end of file
    from the peer, a half-open link found by the heartbeats, or a socket replaced when
    the peer reconnected. A ``ConnectionResetError``, so the process pool's dead-child
    handling classifies it without new except clauses: the feeder first waits a bounded
    ``reconnect()`` (the child redials with jittered backoff) and only then spends the
    respawn budget. The in-flight item is dispatched again under the poison policy:
    delivered exactly once or quarantined."""


class TransportFrameCorrupt(TransportLinkDown):
    """A tcp transport frame whose crc32 trailer, magic or header does not match its
    bytes: a flipped bit on the wire or a desynchronised stream. The link is torn down
    as on a link death (counted in ``ptpu_net_frames_corrupt_total`` and as the
    ``transport_frame_corrupt`` degradation); the corrupt payload is never delivered."""


class StallError(PetastormTpuError):
    """A pipeline actor missed its heartbeat threshold and the health monitor's
    escalation policy is ``raise`` (or ``heal`` with nothing a healer could take): the
    training loop fails fast instead of silently hanging the card. The flight record
    written at detection (``HealthOptions.flight_path``) carries the evidence: driver and
    child stacks, queue depths, recent pipeline events."""
