"""Probabilistic mixing of several readers: each ``next()`` draws one of the underlying
readers with the given probabilities (dataset mixing for multi-corpus training).

Port of ``petastorm_tpu.weighted_sampling``. The draws are numpy's ``PCG64``
``Generator.choice`` over the live readers, as in the JAX package, so for the same seed
the draw sequence is bit for bit the JAX package's, and its ``state_dict`` (the RNG's
state and every sub-reader's cursor) resumes either package's mixer.

The port's :class:`~petastorm_tpu_torch.loader.DataLoader` reads more off a reader than
the JAX loader does; the mixer answers each of those hooks for its sub-readers:

- ``wire_views`` / ``take_lease``: a batch on a shared-memory view wire views a slab its
  sub-reader recycles at that sub-reader's next fetch. The mixer forwards ``take_lease``
  to the sub-reader that delivered the current item, so the loader holds the slab as it
  does for one reader.
- ``wire_stats``: the sub-readers' gauges, summed.
- ``adopt_passthrough`` / ``release_passthrough`` / ``keep_passthrough``: forwarded to
  every sub-reader, all or none, so no sub-reader ships compressed pages that the
  consumer does not inflate.
- ``state_dict`` / ``load_state_dict``: below.
"""
from __future__ import annotations

import numpy as np


class WeightedSamplingReader:
    def __init__(self, readers, probabilities, seed=None):
        if len(readers) != len(probabilities):
            raise ValueError("readers and probabilities must have equal length")
        p = np.asarray(probabilities, dtype=np.float64)
        if (p < 0).any() or p.sum() <= 0:
            raise ValueError("probabilities must be non-negative and sum to > 0")
        self._readers = list(readers)
        self._all = list(readers)  # _readers drops exhausted ones; adoption spans all
        self._p = p / p.sum()
        self._rng = np.random.Generator(np.random.PCG64(seed))
        # mixing readers must agree on ngram-ness (reference behavior)
        self.ngram = readers[0].ngram if hasattr(readers[0], "ngram") else None
        # downstream consumers (adapters, the DataLoader) read these off the reader;
        # expose the first reader's and require the others to agree where it matters
        self.schema = getattr(readers[0], "schema", None)
        self.transform_spec = getattr(readers[0], "transform_spec", None)
        self.is_batched_reader = getattr(readers[0], "is_batched_reader", False)
        for r in readers[1:]:
            if getattr(r, "is_batched_reader", False) != self.is_batched_reader:
                raise ValueError(
                    "Cannot mix per-row and batched readers in WeightedSamplingReader"
                )
        fields = getattr(readers[0], "device_decode_fields", frozenset())
        for r in readers[1:]:
            if getattr(r, "device_decode_fields", frozenset()) != fields:
                raise ValueError(
                    "All mixed readers must stage the same device-decode fields; got "
                    "%r vs %r" % (sorted(fields),
                                  sorted(getattr(r, "device_decode_fields", ()))))
        self.device_decode_fields = fields
        #: final cursor of each exhausted sub-reader (captured at exhaustion so a later
        #: ``state_dict()`` can still checkpoint it as fully consumed)
        self._final_states = {}
        #: index of the sub-reader that delivered the current item (the lease's owner)
        self._current = None

    def __iter__(self):
        return self

    def __next__(self):
        alive = [i for i, r in enumerate(self._readers) if r is not None]
        while alive:
            p = self._p[alive] / self._p[alive].sum()
            pick = int(self._rng.choice(alive, p=p))
            try:
                item = next(self._readers[pick])
                self._current = pick
                return item
            except StopIteration:
                exhausted = self._readers[pick]
                if hasattr(exhausted, "state_dict"):
                    self._final_states[pick] = exhausted.state_dict()
                self._readers[pick] = None
                alive = [i for i, r in enumerate(self._readers) if r is not None]
        self._current = None
        raise StopIteration

    # -- the DataLoader's reader hooks ----------------------------------------------------

    @property
    def wire_views(self):
        """True when any sub-reader delivers read-only views into pool slabs."""
        return any(getattr(r, "wire_views", False) for r in self._all)

    def take_lease(self):
        """The current item's lease, taken from the sub-reader that delivered it (see
        ``Reader.take_lease``); ``None`` when it is not lease-backed."""
        r = self._readers[self._current] if self._current is not None else None
        take = getattr(r, "take_lease", None)
        return take() if take is not None else None

    def wire_stats(self):
        """The sub-readers' process-pool gauges, summed (``{}`` without any)."""
        out = {}
        for r in self._all:
            fn = getattr(r, "wire_stats", None)
            for k, v in (fn() if fn is not None else {}).items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def keep_passthrough(self):
        return any(getattr(r, "keep_passthrough", False) for r in self._all)

    def adopt_passthrough(self, on_device):
        """A DataLoader takes over the pass-through of every sub-reader (each one's
        ``adopt_passthrough``)."""
        for r in self._all:
            if hasattr(r, "adopt_passthrough"):
                r.adopt_passthrough(on_device)

    def release_passthrough(self):
        for r in self._all:
            if hasattr(r, "release_passthrough"):
                r.release_passthrough()

    # -- exact resume -------------------------------------------------------------------

    def state_dict(self):
        """Exact-resume state for the stochastic mixer: the mixing RNG's full state plus
        every sub-reader's cursor (the final cursor for already exhausted ones).
        Restoring into a mixer of the same configuration continues the SAME draw
        sequence with each sub-reader at its own cursor. Sub-readers are at-least-once
        at row-group granularity, so a replayed in-flight group may shift which rows
        later draws return; the mix proportions and the coverage are unchanged. A
        sub-reader exhausted at the save restores empty and is found exhausted at its
        first draw, which costs extra RNG draws against the uninterrupted run:
        draw-for-draw equality holds while every sub-reader is live. Duck-types for
        :mod:`petastorm_tpu_torch.checkpoint` like a reader or loader."""
        states = []
        for i, r in enumerate(self._readers):
            if r is None:
                final = self._final_states.get(i)
                if final is None:
                    # exhausted before a capture was possible: restoring it fresh would
                    # replay its whole corpus, so refuse as in the live case
                    raise AttributeError(
                        "sub-reader %d was exhausted without a capturable state "
                        "(no state_dict); WeightedSamplingReader can only "
                        "checkpoint checkpointable readers" % i)
                states.append(final)
            elif hasattr(r, "state_dict"):
                states.append(r.state_dict())
            else:
                raise AttributeError(
                    "sub-reader %d (%s) has no state_dict; WeightedSamplingReader "
                    "can only checkpoint checkpointable readers"
                    % (i, type(r).__name__))
        return {
            "weighted": True,
            "rng_state": self._rng.bit_generator.state,
            "readers": states,
        }

    def load_state_dict(self, state):
        """Restore into a mixer built over FRESH sub-readers of the same configuration."""
        if not state.get("weighted"):
            raise ValueError(
                "not a WeightedSamplingReader state (single-reader checkpoint? "
                "restore it into that reader instead)")
        saved = state["readers"]
        if len(saved) != len(self._readers):
            raise ValueError(
                "saved state mixes %d readers, this mixer has %d — rebuild with "
                "the original composition" % (len(saved), len(self._readers)))
        for i, (sub_state, r) in enumerate(zip(saved, self._readers)):
            if r is None:
                raise ValueError(
                    "sub-reader %d of this mixer is already exhausted — restore "
                    "requires a FRESHLY built mixer over unconsumed same-config "
                    "sub-readers" % i)
            if sub_state is None:
                raise ValueError(
                    "saved state for sub-reader %d is empty (checkpoint from an "
                    "incompatible version?)" % i)
            r.load_state_dict(sub_state)
        self._rng.bit_generator.state = state["rng_state"]
        self._final_states = {}
        return self

    def stop(self):
        # exhausted sub-readers too: a process pool's ring is unlinked at its join
        for r in self._all:
            r.stop()

    def join(self):
        for r in self._all:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
