"""Deterministic epoch planning: sharding, per-epoch shuffling, resumable cursor.

Port of ``petastorm_tpu.plan`` (``shard_indices``, ``EpochPlan``): the plan is a pure
function of (seed, epoch, shard), so every process derives the same global order and
takes its slice with no communication, and any position checkpoints as a small state
dict (``state_dict``/``load_state_dict``, with a skip map of consumed ordinals for the
reader's exact resume), and ``peek`` gives the next items without advancing (the
readahead lookahead of a synchronous pool). The plan grows under a running reader
(``extend``, the dataset watch of :mod:`petastorm_tpu_torch.dataset.watch`): appended
items join the current epoch, deferred ones the next, and ``items_in_epoch`` tells the
reader's watermark how many items each epoch holds.
"""
from __future__ import annotations

import threading

import numpy as np


def shard_indices(num_items, cur_shard, shard_count, shard_seed=None):
    """Deterministic round-robin partition of ``range(num_items)`` for one shard.

    Optional seeded global permutation, then round-robin. Every shard computes the same
    permutation, so shards are disjoint and their union is exact."""
    if shard_count is None:
        return np.arange(num_items)
    if not (0 <= cur_shard < shard_count):
        raise ValueError(
            "cur_shard must be in [0, %d), got %r" % (shard_count, cur_shard)
        )
    order = np.arange(num_items)
    if shard_seed is not None:
        order = np.random.Generator(np.random.PCG64(shard_seed)).permutation(num_items)
    return order[cur_shard::shard_count]


def epoch_permutation(num_items, epoch, seed, shuffle):
    """Permutation of ``range(num_items)`` for one epoch; identity when not shuffling.
    Seeded by (seed, epoch): the same numbers as the JAX package's plan."""
    if not shuffle:
        return np.arange(num_items)
    seq = np.random.SeedSequence([0 if seed is None else int(seed), int(epoch)])
    return np.random.Generator(np.random.PCG64(seq)).permutation(num_items)


class EpochPlan:
    """Thread-safe, resumable iterator over plan items across epochs.

    ``num_epochs=None`` means infinite. ``with_epoch=True`` yields
    ``(epoch, ordinal, item)`` instead of ``item``. ``skip``: optional
    ``{epoch: set(ordinal)}`` of already-consumed work to omit.

    The plan is extensible: :meth:`extend` appends items discovered mid-run, into the
    current epoch (appended files) or the next one (``defer=True``: a rewritten file's
    new generation must not share an epoch with the old one). Extension is thread-safe
    against iteration (the dataset watcher extends from its own thread), and
    :meth:`items_in_epoch` keeps the reader's consumed-ordinal watermark exact across
    extensions."""

    def __init__(self, items, num_epochs=1, shuffle=False, seed=None, with_epoch=False,
                 skip=None):
        self._items = list(items)
        if num_epochs is not None and (not isinstance(num_epochs, int) or num_epochs < 1):
            raise ValueError("num_epochs must be a positive integer or None, got %r" % num_epochs)
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._seed = seed
        self._with_epoch = with_epoch
        self._skip = {int(k): set(v) for k, v in (skip or {}).items()}
        self._epoch = 0
        self._pos = 0
        self._perm = epoch_permutation(len(self._items), 0, seed, shuffle)
        #: the extension ledger, ``(birth_epoch, item_count)``: the initial items are
        #: born in epoch 0, each extend() appends one entry (items_in_epoch reads it)
        self._births = [(0, len(self._items))]
        self._lock = threading.Lock()

    @property
    def items(self):
        return self._items

    @property
    def epoch(self):
        return self._epoch

    def __iter__(self):
        return self

    def _step(self, epoch, pos, perm):
        """Advance a cursor triple by one raw position (skip map not applied): returns
        ``(yield_epoch, ordinal, epoch, pos, perm)``. The one copy of the roll-over and
        reshuffle: :meth:`__next__` moves the plan's cursor with it, :meth:`peek` walks
        a detached copy, so the two cannot drift."""
        yield_epoch = epoch
        ordinal = int(perm[pos])
        pos += 1
        # roll over at the permutation's end, not the item count's: a deferred
        # extension grows the items without touching this epoch's permutation, and
        # its items first appear in the next epoch's
        if pos >= len(perm):
            pos = 0
            epoch += 1
            if self._num_epochs is None or epoch < self._num_epochs:
                perm = epoch_permutation(len(self._items), epoch, self._seed,
                                         self._shuffle)
        return yield_epoch, ordinal, epoch, pos, perm

    def __next__(self):
        with self._lock:
            while True:
                if not self._items or self.exhausted():
                    raise StopIteration
                epoch, ordinal, self._epoch, self._pos, self._perm = \
                    self._step(self._epoch, self._pos, self._perm)
                if self._skip and ordinal in self._skip.get(epoch, ()):
                    continue
                item = self._items[ordinal]
                return (epoch, ordinal, item) if self._with_epoch else item

    def peek(self, n):
        """The next ``n`` yields of :meth:`__next__` without advancing the cursor: the
        readahead window of a synchronous pool. Same advance as ``__next__`` (skip map,
        epoch roll-over, per-epoch reshuffle); fewer than ``n`` items when the plan is
        nearly exhausted."""
        out = []
        with self._lock:
            if not self._items:
                return out
            epoch, pos, perm = self._epoch, self._pos, self._perm
            while len(out) < n:
                if self._num_epochs is not None and epoch >= self._num_epochs:
                    break
                yield_epoch, ordinal, epoch, pos, perm = self._step(epoch, pos, perm)
                if self._skip and ordinal in self._skip.get(yield_epoch, ()):
                    continue
                item = self._items[ordinal]
                out.append((yield_epoch, ordinal, item) if self._with_epoch else item)
        return out

    def extend(self, new_items, defer=False):
        """Append newly discovered ``new_items`` to a live plan.

        ``defer=False`` puts them in the current epoch, at the tail of its running
        permutation (shuffled among themselves by ``(seed, epoch, first ordinal)`` when
        the plan shuffles): positions already consumed are untouched, so nothing
        replays. ``defer=True`` puts them in the next epoch. Returns the ordinals of the
        new items; existing ordinals keep their identity, so consumed-ordinal
        checkpoints taken before or after an extension stay exact."""
        new_items = list(new_items)
        if not new_items:
            return []
        with self._lock:
            start = len(self._items)
            self._items.extend(new_items)
            self._births.append((self._epoch + (1 if defer else 0), len(new_items)))
            new_ords = np.arange(start, len(self._items))
            if not defer:
                ords = new_ords
                if self._shuffle:
                    seq = np.random.SeedSequence(
                        [0 if self._seed is None else int(self._seed), int(self._epoch),
                         int(start)])
                    ords = ords[np.random.Generator(np.random.PCG64(seq)).permutation(
                        len(ords))]
                self._perm = np.concatenate([self._perm, ords])
            return [int(o) for o in new_ords]

    def positions(self, epoch):
        """``positions[ordinal]``: where each item comes in ``epoch``'s order (the order
        one worker delivers the epoch in); None once the plan has grown (:meth:`extend`
        appends to the running order)."""
        with self._lock:
            if len(self._births) > 1:
                return None
            return np.argsort(epoch_permutation(len(self._items), epoch, self._seed,
                                                self._shuffle))

    def items_in_epoch(self, epoch):
        """How many plan items belong to ``epoch`` (those born at or before it): the
        denominator of the reader's consumed-ordinal watermark."""
        with self._lock:
            return sum(count for birth, count in self._births if birth <= epoch)

    def exhausted(self):
        if not self._items:
            return True
        return self._num_epochs is not None and self._epoch >= self._num_epochs

    def reset(self):
        """Restart from epoch 0. Every item known so far, extensions included, is part
        of the restarted epoch 0 (the births collapse: the plan replays the dataset as
        now known)."""
        with self._lock:
            self._epoch = 0
            self._pos = 0
            self._skip = {}
            self._perm = epoch_permutation(len(self._items), 0, self._seed, self._shuffle)
            self._births = [(0, len(self._items))]

    def set_skip(self, skip):
        """Set the {epoch: set(ordinal)} map of work to omit (consumed-aware resume)."""
        with self._lock:
            self._skip = {int(k): set(v) for k, v in (skip or {}).items()}

    # -- checkpoint/resume ---------------------------------------------------------------

    def state_dict(self):
        return {
            "epoch": self._epoch,
            "pos": self._pos,
            "seed": self._seed,
            "shuffle": self._shuffle,
            "num_epochs": self._num_epochs,
            "num_items": len(self._items),
        }

    def load_state_dict(self, state):
        # fewer items than the checkpoint saw is a real mismatch (ordinals in the
        # consumed map would dangle); more is legal: files appended after the save are
        # simply unconsumed
        if state["num_items"] > len(self._items):
            raise ValueError(
                "Checkpoint was taken over %d items; plan has %d"
                % (state["num_items"], len(self._items))
            )
        if state["num_items"] < len(self._items) and state["shuffle"] \
                and int(state["pos"]):
            # a mid-epoch position is only meaningful against the exact permutation it
            # was taken over; a grown shuffled plan derives a different one, so the
            # position would replay some consumed ordinals and lose some others (the
            # Reader's resume is immune: pos 0 and the consumed-ordinal skip map)
            raise ValueError(
                "cannot restore a mid-epoch shuffled checkpoint (pos=%d) into "
                "a grown plan (%d -> %d items): the permutation changed; "
                "resume via a consumed-ordinal skip map (pos=0 + set_skip), "
                "as Reader.load_state_dict does"
                % (state["pos"], state["num_items"], len(self._items)))
        with self._lock:
            self._epoch = int(state["epoch"])
            self._pos = int(state["pos"])
            self._seed = state["seed"]
            self._shuffle = state["shuffle"]
            self._num_epochs = state["num_epochs"]
            self._perm = epoch_permutation(
                len(self._items), self._epoch, self._seed, self._shuffle
            )
            self._births = [(0, len(self._items))]
