"""Checkpointing of the data-plane state: ``torch.save`` and ``torch.distributed.checkpoint``.

Port of ``petastorm_tpu.checkpoint`` with its public functions and semantics, orbax
replaced. ``Reader.state_dict()`` already gives exact mid-epoch resume (the consumed-work
map); this module makes that state a first-class item of a checkpoint:

- :func:`save` / :func:`restore` write and read a standalone checkpoint of the data-plane
  state alone (``torch.save``, ``torch.load(weights_only=True)``: the state is plain
  data);
- :func:`state_item` wraps a reader or loader as a ``Stateful`` item that
  ``torch.distributed.checkpoint`` saves beside a model's state, in one checkpoint::

      import torch.distributed.checkpoint as dcp
      from petastorm_tpu_torch import checkpoint as ptck

      dcp.save({"model": model.state_dict(), "data": ptck.state_item(loader)},
               checkpoint_id=ckpt_dir)
      ...
      dcp.load({"model": model.state_dict(), "data": ptck.state_item(loader)},
               checkpoint_id=ckpt_dir)

  DCP flattens nested dicts and expects string keys, so the item carries the state as
  one JSON string under one key and turns it back into the reader's form on load.

Multi-process: ``Reader.state_dict()`` is per process (each process owns its shard's
plan), so :func:`global_state_dict` gathers every process's state into one payload
(``torch.distributed.all_gather_object``) before a write, and :func:`apply` routes each
process its own shard's entry on restore (keyed by ``cur_shard``, falling back to the
rank). Replicas of one shard intersect their consumed sets, so each resumes
at-least-once.

When batches flow through a :class:`petastorm_tpu_torch.loader.DataLoader`, pass the
LOADER to these functions instead of the reader: it duck-types as a reader and
checkpoints at the consumer watermark, so rows prefetched into the loader's queues but
not yet taken replay after a restore instead of being skipped.

A :class:`~petastorm_tpu_torch.weighted_sampling.WeightedSamplingReader` and an
:class:`~petastorm_tpu_torch.loader.InMemDataLoader` duck-type as readers here too: the
mixer's state is its RNG's and its sub-readers', the in-memory loader's its
``(epoch, batch)`` cursor.

:func:`from_reference_state` takes the JAX package's ``Reader.state_dict()`` (plain dicts
and lists, or its JSON form) and returns the port's: the two are the same data, so a
state saved by either package resumes the other's reader on the same store. So does a
mixer's (numpy's RNG state, the sub-readers' states converted), and an
``InMemDataLoader`` cursor with ``shuffle=False``. A shuffled ``InMemDataLoader`` cursor
is refused: the JAX package's epochs are ``jax.random`` permutations and the port's
``torch.randperm`` orders, so the cursor would serve other rows.
"""
from __future__ import annotations

import json
import os

#: Marker key of a gathered multi-process payload (a plain per-process state never
#: contains it: ``Reader.state_dict`` keys are fixed). The JAX package's key.
_GLOBAL_KEY = "ptpu_per_process"

#: The one key under which :func:`state_item` carries the state (a JSON string).
_ITEM_KEY = "state_json"


def _dist():
    """``torch.distributed`` when it is initialised with more than one process, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist
    return None


def global_state_dict(reader):
    """COLLECTIVE when ``torch.distributed`` runs more than one process: every process
    must call it, in the same order (one ``all_gather_object``).

    The complete data-plane state: ``{_GLOBAL_KEY: {shard_key: state}}`` with one entry
    per process when several run, or this process's plain state dict when it is alone."""
    state = reader.state_dict()
    dist = _dist()
    if dist is None:
        return state
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [_shard_key(reader), state])
    return {_GLOBAL_KEY: _merge_states(gathered)}


def apply(reader, restored_state):
    """Load a restored state dict into a freshly built reader or loader (same dataset
    and configuration).

    A global (multi-process) payload is routed: each process takes its own shard's entry
    by ``cur_shard`` (the rank when unsharded). The reader resumes at the consumed-work
    watermark: fully delivered row groups are skipped; in-flight ones replay in full
    (at-least-once at row-group granularity)."""
    state = dict(restored_state)
    per_process = state.get(_GLOBAL_KEY)
    if per_process is not None:
        key = _shard_key(reader)
        if key not in per_process:
            raise ValueError(
                "Global checkpoint has no entry for shard %r (available: %s); was the "
                "pod resharded? Rebuild readers with the original cur_shard/"
                "shard_count, or re-shard the dataset and start a fresh epoch."
                % (key, sorted(per_process)))
        state = per_process[key]
    reader.load_state_dict(_denormalize(state))
    return reader


def save(path, reader):
    """Standalone checkpoint of the data-plane state at ``path`` (a file, written with
    ``torch.save``; COLLECTIVE when several processes run: every process must call it,
    the first one writes, and all return once the file is complete)."""
    import torch

    state = global_state_dict(reader)
    dist = _dist()
    if dist is None or dist.get_rank() == 0:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        torch.save(state, tmp)
        os.replace(tmp, path)  # a reader of the path never sees half a file
    if dist is not None:
        dist.barrier()


def restore(path, reader):
    """Restore a standalone :func:`save` checkpoint into ``reader`` (or a loader)."""
    import torch

    return apply(reader, torch.load(path, weights_only=True))


class _StateItem:
    """The ``Stateful`` form of a reader's or loader's state for
    ``torch.distributed.checkpoint``: one JSON string under one key."""

    def __init__(self, reader):
        self._reader = reader

    def state_dict(self):
        return {_ITEM_KEY: json.dumps(global_state_dict(self._reader))}

    def load_state_dict(self, state_dict):
        apply(self._reader, json.loads(state_dict[_ITEM_KEY]))


def state_item(reader):
    """``reader`` (or a ``DataLoader``) as an item of a ``torch.distributed.checkpoint``
    state dict: an object with ``state_dict``/``load_state_dict`` (the ``Stateful``
    protocol). Its ``state_dict()`` is COLLECTIVE when several processes run (the state
    is gathered, as :func:`global_state_dict` does), so every process must save."""
    return _StateItem(reader)


def from_reference_state(state):
    """The port's reader state from the JAX package's ``Reader.state_dict()`` (or its
    JSON round trip, or a global payload of them): the same keys and values as plain
    Python data, epoch keys as ints, consumed ordinals as sorted lists. A
    ``WeightedSamplingReader`` state converts its sub-readers' states; an
    ``InMemDataLoader`` cursor passes when ``shuffle`` is off and raises ``ValueError``
    when it is on (the two packages' permutations differ)."""
    # through JSON, the form the two packages share: a value that is not JSON data
    # fails here, not at a later restore
    state = json.loads(state if isinstance(state, (str, bytes)) else json.dumps(state))
    if _GLOBAL_KEY in state:
        return {_GLOBAL_KEY: {str(k): from_reference_state(v)
                              for k, v in state[_GLOBAL_KEY].items()}}
    if state.get("weighted"):
        return {**state, "readers": [from_reference_state(s) for s in state["readers"]]}
    if state.get("inmem"):
        if state.get("shuffle"):
            raise ValueError(
                "a shuffled InMemDataLoader cursor of the JAX package cannot resume the "
                "port's loader: its epochs are jax.random (threefry) permutations, the "
                "port's torch.randperm orders, so the cursor would serve other rows. "
                "Resume with shuffle=False, or start the port's loader at an epoch "
                "boundary.")
        return state
    missing = {"plan", "resume_epoch", "consumed"} - set(state)
    if missing:
        raise ValueError("not a Reader state: missing %s (keys: %s)"
                         % (sorted(missing), sorted(state)))
    state = _denormalize(state)
    state["consumed"] = {e: sorted(int(o) for o in v) for e, v in state["consumed"].items()}
    state["resume_epoch"] = int(state["resume_epoch"])
    return state


def _shard_key(reader):
    """Stable identity of this process's shard in a global payload."""
    cur = getattr(reader, "cur_shard", None)
    if cur is None:
        import torch.distributed as dist

        cur = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return str(cur)


def _merge_states(pairs):
    """Merge gathered ``[shard_key, state]`` pairs into ``{shard_key: state}``.

    Replica groups (several processes reading the SAME shard) gather duplicate keys,
    possibly with timing skew between the replicas' consumed sets. The merged entry
    INTERSECTS the replicas' consumed sets per epoch (and takes the least resume epoch):
    a restore then skips only work EVERY replica fully delivered, so each replica
    resumes at-least-once. Same-key states must share a plan (seed, shuffle, epochs):
    differently configured readers are not replicas."""
    out = {}
    for k, st in pairs:
        k = str(k)
        if k in out and out[k] != st:
            prev = out[k]
            if prev.get("plan") != st.get("plan"):
                raise ValueError(
                    "Shard key %r was checkpointed by readers with different plans "
                    "(%r vs %r) — replicas of one shard must share seed/shuffle/"
                    "epoch config, or use distinct cur_shard values"
                    % (k, prev.get("plan"), st.get("plan")))
            out[k] = _intersect_states(prev, st)
            continue
        out[k] = st
    return out


def _intersect_states(a, b):
    merged = dict(a)
    merged["resume_epoch"] = min(int(a["resume_epoch"]), int(b["resume_epoch"]))
    ca = {int(e): set(v) for e, v in a.get("consumed", {}).items()}
    cb = {int(e): set(v) for e, v in b.get("consumed", {}).items()}
    merged["consumed"] = {
        e: sorted(ca[e] & cb[e]) for e in (set(ca) & set(cb)) if ca[e] & cb[e]}
    return merged


def _denormalize(state):
    """A JSON round trip turns the integer epoch keys of ``consumed`` into strings;
    restore them."""
    state = dict(state)
    if "consumed" in state:
        state["consumed"] = {int(k): v for k, v in state["consumed"].items()}
    return state
