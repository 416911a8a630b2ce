"""Sequence/context parallelism: ring attention and Ulysses (all-to-all) attention over
``torch.distributed``.

Port of ``petastorm_tpu.parallel.attention``. Each rank holds a block of the sequence
(``parallel.mesh.sequence_sharding``) and runs its part with explicit collectives over
the mesh's sequence axis (:mod:`petastorm_tpu_torch.parallel.collectives`):

- **Ring attention**: K/V blocks rotate around the ``sp`` ring (:func:`ppermute`, one
  send and one receive a step, key and value stacked into one tensor) while each rank
  keeps its Q block; the softmax accumulates online (a log-sum-exp carry in float32),
  so no rank holds the full score matrix.
- **Ulysses**: an all-to-all reshards sequence-sharded blocks to head-sharded ones,
  plain attention runs over the full sequence for the local heads, and the inverse
  all-to-all reshards back. Needs heads divisible by the axis size.

The attention is plain einsums, as in the JAX package (:func:`reference_attention` is
the oracle). The functions are differentiable; :func:`ring_self_attention` and
:func:`ulysses_self_attention` take and return the mesh-level sequence-sharded
DTensors.
"""
from __future__ import annotations

import torch

from petastorm_tpu_torch.parallel.collectives import (all_to_all, axis_index, axis_size,
                                                      ppermute)


def reference_attention(q, k, v, causal=False):
    """Dense softmax attention over (b, s, h, d): the correctness oracle."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ring_attention(q, k, v, mesh, axis="sp", causal=False):
    """Ring attention over the sharded sequence axis ``axis`` of ``mesh``.

    ``q``, ``k``, ``v`` are this rank's blocks (b, s_local, h, d); the global sequence
    is the blocks in axis order. Returns the local output block, accumulated in float32
    and cast back to ``q``'s dtype."""
    ring = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    b, s_loc, h, d = q.shape
    scale = d ** -0.5
    q32 = q.float()
    o = torch.zeros_like(q32)
    m = torch.full((b, h, s_loc), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_loc), device=q.device)
    kv = torch.stack([k, v])
    pos = torch.arange(s_loc, device=q.device)
    for i in range(ring):
        held = (me - i) % ring  # whose block this rank holds at step i
        k_blk, v_blk = kv[0].float(), kv[1].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk) * scale
        if causal:
            visible = (me * s_loc + pos)[:, None] >= (held * s_loc + pos)[None, :]
            scores = scores.masked_fill(~visible, float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # fully masked rows keep m = -inf: guard the exp against -inf - -inf
        safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(scores - safe_m[..., None])
        p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
        m = m_new
        if i < ring - 1:  # the last rotation's blocks would go unused
            kv = ppermute(kv, mesh, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully masked rows: zeros, not NaN
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, mesh, axis="sp", causal=False):
    """Ulysses sequence parallelism over ``axis``: all-to-all (b, s/N, h, d) → (b, s,
    h/N, d), dense attention for the local head group over the full sequence, then the
    inverse all-to-all."""
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError("Ulysses needs heads (%d) divisible by axis size (%d)"
                         % (q.shape[2], n))
    qh, kh, vh = (all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    oh = reference_attention(qh, kh, vh, causal=causal)
    return all_to_all(oh, mesh, axis, split_axis=1, concat_axis=2)


def _mesh_wrap(fn, q, k, v, mesh, seq_axis, causal):
    """Run ``fn`` on the local blocks of sequence-sharded DTensors and deliver the
    result laid out as ``q`` is; plain tensors are taken as the local blocks."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return fn(q, k, v, mesh, seq_axis, causal)
    out = fn(q.to_local(), k.to_local(), v.to_local(), mesh, seq_axis, causal)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def ring_self_attention(q, k, v, mesh, seq_axis="sp", batch_axis="dp", causal=False):
    """Mesh-level ring attention: ``q``/``k``/``v`` are global (b, s, h, d) DTensors
    sequence-sharded over ``seq_axis`` (e.g. the loader's delivery under
    ``parallel.mesh.sequence_sharding``, or ``distribute_tensor``); the output is laid
    out the same way. ``batch_axis`` names the batch's axis, as in the JAX function (the
    DTensor's placements carry it)."""
    return _mesh_wrap(ring_attention, q, k, v, mesh, seq_axis, causal)


def ulysses_self_attention(q, k, v, mesh, seq_axis="sp", batch_axis="dp", causal=False):
    """Mesh-level Ulysses attention over a sequence-sharded batch (see
    :func:`ring_self_attention`)."""
    return _mesh_wrap(ulysses_attention, q, k, v, mesh, seq_axis, causal)
