"""SPMD MoE transformer: the flagship multi-parallel training step over
``torch.distributed``.

Port of ``petastorm_tpu.models.transformer``, with its functional API (a parameter
dict, :func:`make_train_step`, :func:`reference_loss`). Every batch from the
:class:`~petastorm_tpu_torch.loader.DataLoader` under :func:`data_sharding` can be
consumed by a step sharded over

- **dp**: batch split; gradients summed over (dp, sp),
- **pp**: GPipe microbatch pipeline over stage-stacked layer params
  (:func:`petastorm_tpu_torch.parallel.pipeline.spmd_pipeline`, ppermute hops),
- **sp**: sequence split with ring attention
  (:func:`petastorm_tpu_torch.parallel.attention.ring_attention`),
- **tp**: Megatron-style column/row-parallel projections (heads and FFN hidden split;
  one all-reduce a block),
- **ep**: expert parallelism: top-1 gated MoE, tokens routed to expert shards with a
  pair of all-to-alls (GShard-style static-capacity dispatch einsums).

The JAX step runs inside one ``shard_map``, where each ``psum`` and each meeting of a
replicated value with a sharded one transposes by the varying-axes types. Here each
rank runs its local part with explicit collectives
(:mod:`petastorm_tpu_torch.parallel.collectives`), placed so the gradients are JAX's:
:func:`~.collectives.f` where a replicated activation meets a sharded weight or slice
(the cotangent sums), :func:`~.collectives.g` for each ``psum`` of the forward (the
cotangent does not), and after the backward pass each parameter's gradient summed over
the mesh axes it is replicated on and its computation varies over: (dp, sp) for every
parameter, and ep too for the gate ``wg``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.parallel.attention import reference_attention, ring_attention
from petastorm_tpu_torch.parallel.collectives import (all_reduce_, all_to_all, axis_index,
                                                      axis_size, f, g)
from petastorm_tpu_torch.parallel.mesh import to_local
from petastorm_tpu_torch.parallel.pipeline import spmd_pipeline, tree_map

AXES = ("dp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 8
    head_dim: int = 16
    d_ff: int = 128
    n_stages: int = 2          # pipeline depth (== mesh pp size)
    layers_per_stage: int = 1
    n_experts: int = 4
    capacity_factor: float = 2.0
    max_seq: int = 256
    dtype: Any = torch.float32   # bfloat16 on the card's tensor cores


def init_params(cfg, generator=0, device="cuda"):
    """Global (unsharded) parameter dict; stage-stacked tensors lead with n_stages.
    ``generator``: a ``torch.Generator`` or a seed; the values are drawn on the
    generator's device and moved to ``device``."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    s, L = cfg.n_stages, cfg.layers_per_stage
    d, H, hd, ff, E = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_experts

    def init(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device) * scale
        return x.to(device=device, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    return {
        "embed": init((cfg.vocab, d), 0.02),
        "pos": init((cfg.max_seq, d), 0.02),
        "stages": {
            "ln1": ones((s, L, d)),
            "wqkv": init((s, L, d, 3, H, hd), d ** -0.5),
            "wo": init((s, L, H, hd, d), (H * hd) ** -0.5),
            "ln2": ones((s, L, d)),
            "wg": init((s, L, d, E), 0.02),
            "w1": init((s, L, E, d, ff), d ** -0.5),
            "w2": init((s, L, E, ff, d), ff ** -0.5),
        },
        "ln_f": ones((d,)),
        "unembed": init((d, cfg.vocab), d ** -0.5),
    }


def model_mesh(axis_sizes=None, devices=None, device_type="cuda"):
    """Mesh for this model: always declares all five axes (size 1 where unused), so
    the step's collectives are well formed whichever axes actually split."""
    from petastorm_tpu_torch.parallel.mesh import make_mesh

    sizes = {"pp": 1, "ep": 1, "sp": 1, "tp": 1}
    sizes.update(axis_sizes or {})
    return make_mesh(sizes, devices=devices, device_type=device_type)


def _check_mesh(mesh):
    missing = set(AXES) - set(mesh.mesh_dim_names or ())
    if missing:
        raise ValueError("mesh is missing axes %s; build it with model_mesh()"
                         % sorted(missing))


def param_shardings(cfg, mesh):
    """NamedShardings: stages over pp; heads/ffn-hidden over tp; experts over ep. The
    mesh must declare all of dp/pp/ep/sp/tp (use :func:`model_mesh`)."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P

    _check_mesh(mesh)

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return {
        "embed": ns(), "pos": ns(), "ln_f": ns(), "unembed": ns(),
        "stages": {
            "ln1": ns("pp"),
            "wqkv": ns("pp", None, None, None, "tp", None),
            "wo": ns("pp", None, "tp", None, None),
            "ln2": ns("pp"),
            "wg": ns("pp"),
            "w1": ns("pp", None, "ep", None, "tp"),
            "w2": ns("pp", None, "ep", "tp", None),
        },
    }


def _local_slice(tensor, sharding):
    """This rank's block of a global ``tensor`` laid out by ``sharding``."""
    from petastorm_tpu_torch.parallel.mesh import axis_coordinate

    for d, part in enumerate(sharding.spec):
        if part is None:
            continue
        index, k = axis_coordinate(sharding.mesh, (part,) if isinstance(part, str)
                                   else part)
        n = tensor.shape[d] // k
        tensor = tensor.narrow(d, index * n, n)
    return tensor.contiguous()


def _zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def distribute_params(params, shardings):
    """The global ``params`` (the same on every rank: :func:`init_params` from one seed)
    as DTensors laid out by ``shardings`` (:func:`param_shardings`), each rank keeping
    its own block; no collective runs."""
    from torch.distributed.tensor import DTensor

    def place(t, s):
        return DTensor.from_local(_local_slice(t, s), s.mesh, s.placements(),
                                  run_check=False, shape=t.shape, stride=t.stride())

    return _zip(place, params, shardings)


def _rms_norm(x, scale):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


def _attention_block(x, ln, wqkv, wo, mesh):
    """Ring attention over sp; heads local to the tp rank (column/row parallel)."""
    h = f(_rms_norm(x, ln), mesh, "tp")
    qkv = torch.einsum("bsd,dthe->bsthe", h, wqkv)  # t=3, h=H_local, e=head_dim
    o = ring_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mesh, "sp", causal=True)
    out = torch.einsum("bshe,hed->bsd", o, wo)
    return x + g(out, mesh, "tp")


def _dispatch(h, wg, n_experts, capacity):
    """GShard top-1 dispatch with a static capacity: ``(dispatch (T, E, C), gate value
    (T,))``. A token past its expert's capacity gets a zero dispatch row (the JAX
    package's ``one_hot`` of an index >= C; torch's raises, so the index is clamped and
    the row masked)."""
    gates = torch.softmax(torch.einsum("td,de->te", h, wg).float(), dim=-1)
    onehot = F.one_hot(gates.argmax(dim=-1), n_experts).float()
    pos_in_e = (onehot.cumsum(dim=0) - 1.0) * onehot
    keep = onehot * (pos_in_e < capacity)
    slot = pos_in_e.long().clamp(0, capacity - 1)
    in_cap = (pos_in_e < capacity).float()[..., None]
    dispatch = keep[..., None] * F.one_hot(slot, capacity).float() * in_cap
    return dispatch, (gates * keep).sum(dim=-1)


def _moe_block(x, ln, wg, w1, w2, cfg, mesh):
    """Top-1 expert-parallel MoE with static capacity (GShard dispatch einsums).

    Tokens split over the ``ep`` axis (each rank gates its own T/ep slice), expert
    inputs are exchanged with an all-to-all pair, and the ranks' outputs reassemble by
    placing and summing over ``ep``."""
    b, s, d = x.shape
    h_full = _rms_norm(x, ln).reshape(b * s, d)
    T, E = h_full.shape[0], cfg.n_experts
    ep = axis_size(mesh, "ep")
    if T % ep:
        raise ValueError("local tokens %d not divisible by ep=%d" % (T, ep))
    T_loc = T // ep
    ep_idx = axis_index(mesh, "ep")
    # the slice by the ep index: each rank's cotangent is its slice's, summed over ep
    h = f(h_full, mesh, "ep")[ep_idx * T_loc:(ep_idx + 1) * T_loc]
    C = max(1, int(math.ceil(T_loc / E * cfg.capacity_factor)))
    dispatch, gate_val = _dispatch(h, wg, E, C)

    expert_in = torch.einsum("tec,td->ecd", dispatch, h.float())            # (E, C, d)
    # split E over the ep ranks; gather every rank's token slots for my local experts
    expert_in = all_to_all(expert_in, mesh, "ep", split_axis=0, concat_axis=1)
    expert_in = f(expert_in.to(cfg.dtype), mesh, "tp")
    hidden = torch.relu(torch.einsum("ecd,edf->ecf", expert_in, w1))      # f = f_local
    out = g(torch.einsum("ecf,efd->ecd", hidden, w2), mesh, "tp")          # row-parallel
    out = all_to_all(out, mesh, "ep", split_axis=1, concat_axis=0)        # (E, C, d)
    y = torch.einsum("tec,ecd->td", dispatch, out.float()) * gate_val[:, None]
    if ep > 1:
        placed = F.pad(y, (0, 0, ep_idx * T_loc, T - (ep_idx + 1) * T_loc))
        y = g(placed, mesh, "ep")                                         # (T, d)
    return x + y.reshape(b, s, d).to(x.dtype)


def _make_stage_fn(cfg, mesh):
    """``stage_fn(stage_params, x)`` over the stage's local layer stack."""

    def stage_fn(stage_params, x):
        for layer in range(cfg.layers_per_stage):
            lp = {k: v[layer] for k, v in stage_params.items()}
            x = _attention_block(x, lp["ln1"], lp["wqkv"], lp["wo"], mesh)
            x = _moe_block(x, lp["ln2"], lp["wg"], lp["w1"], lp["w2"], cfg, mesh)
        return x

    return stage_fn


def make_train_step(cfg, mesh, n_micro=2, learning_rate=1e-2):
    """``train_step(params, tokens, targets) -> (params, loss)``, one SGD step.

    ``params``: DTensors laid out per :func:`param_shardings` (:func:`distribute_params`);
    ``tokens``/``targets``: (batch, seq) integer DTensors laid out per
    :func:`data_sharding` (what the loader delivers under it), or this rank's local
    blocks. Returns the updated params in the same layout and the global mean loss (a
    float32 scalar tensor on every rank)."""
    _check_mesh(mesh)
    ep_size, tp_size = axis_size(mesh, "ep"), axis_size(mesh, "tp")
    pp_size = axis_size(mesh, "pp")
    if cfg.n_stages != pp_size:
        raise ValueError(
            "cfg.n_stages (%d) must equal the mesh pp size (%d): spmd_pipeline assigns "
            "exactly one stage per pp rank" % (cfg.n_stages, pp_size))
    if cfg.n_heads % tp_size or cfg.d_ff % tp_size or cfg.n_experts % ep_size:
        raise ValueError("heads/d_ff/experts must divide tp/ep mesh sizes")
    stage_fn = _make_stage_fn(cfg, mesh)
    data_ranks = axis_size(mesh, "dp") * axis_size(mesh, "sp")

    def local_loss(params, tokens, targets):
        # tokens: (b_local, s_local); embed + absolute positions (global via sp index)
        b_loc, s_loc = tokens.shape
        sp_idx = axis_index(mesh, "sp")
        x = params["embed"][tokens.long()] \
            + params["pos"][sp_idx * s_loc:(sp_idx + 1) * s_loc]
        if b_loc % n_micro:
            raise ValueError("local batch %d not divisible by n_micro=%d" % (b_loc, n_micro))
        xm = x.reshape(n_micro, b_loc // n_micro, s_loc, cfg.d_model)
        y = spmd_pipeline(stage_fn, params["stages"], xm, mesh, "pp")
        y = _rms_norm(y.reshape(b_loc, s_loc, cfg.d_model), params["ln_f"])
        logits = torch.einsum("bsd,dv->bsv", y, params["unembed"]).float()
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
        # global mean over the data axes (batch x sequence partitions)
        return g(nll.sum(), mesh, ("dp", "sp")) / float(b_loc * s_loc * data_ranks)

    def train_step(params, tokens, targets):
        from torch.distributed.tensor import DTensor

        leaves = tree_map(lambda p: to_local(p).detach().requires_grad_(), params)
        flat = _flatten(leaves)
        loss = local_loss(leaves, to_local(tokens), to_local(targets))
        grads = torch.autograd.grad(loss, [t for _k, t in flat])
        new = {}
        for (key, p), grad in zip(flat, grads):
            # replicated over dp and sp, computed from each rank's tokens: summed there;
            # the gate also sees each ep rank's own tokens
            all_reduce_(grad, mesh, ("dp", "sp", "ep") if key == "wg" else ("dp", "sp"))
            new[key] = (p - learning_rate * grad.to(p.dtype)).detach()

        def relayout(old, key):
            local = new[key]
            if not isinstance(old, DTensor):
                return local
            return DTensor.from_local(local, old.device_mesh, old.placements,
                                      run_check=False, shape=old.shape, stride=old.stride())

        return _unflatten(params, relayout), loss.detach()

    return train_step


def _flatten(tree):
    """``[(key, tensor)]`` of a parameter dict; the key is the leaf's name (unique in
    this model's dict)."""
    out = []
    for k, v in tree.items():
        out.extend(_flatten(v) if isinstance(v, dict) else [(k, v)])
    return out


def _unflatten(tree, fn):
    return {k: (_unflatten(v, fn) if isinstance(v, dict) else fn(v, k))
            for k, v in tree.items()}


def data_sharding(mesh):
    """Sharding the DataLoader should use for (batch, seq) token batches of this
    model."""
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P("dp", "sp"))


def reference_loss(cfg, params, tokens, targets, n_micro=2):
    """Dense single-device oracle replicating the sharded forward exactly (for tests)."""
    x = params["embed"][tokens.long()] + params["pos"][None, : tokens.shape[1]]
    h = x
    for s in range(cfg.n_stages):
        for layer in range(cfg.layers_per_stage):
            lp = {k: v[s, layer] for k, v in params["stages"].items()}
            qkv = torch.einsum("bsd,dthe->bsthe", _rms_norm(h, lp["ln1"]), lp["wqkv"])
            o = reference_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True)
            h = h + torch.einsum("bshe,hed->bsd", o, lp["wo"])
            # dense MoE with the same static capacity semantics
            b, sq, d = h.shape
            hm = _rms_norm(h, lp["ln2"]).reshape(b * sq, d)
            T, E = hm.shape[0], cfg.n_experts
            C = max(1, int(math.ceil(T / E * cfg.capacity_factor)))
            dispatch, gate_val = _dispatch(hm, lp["wg"], E, C)
            ein = torch.einsum("tec,td->ecd", dispatch, hm.float()).to(cfg.dtype)
            hid = torch.relu(torch.einsum("ecd,edf->ecf", ein, lp["w1"]))
            out = torch.einsum("ecf,efd->ecd", hid, lp["w2"])
            y = torch.einsum("tec,ecd->td", dispatch, out.float()) * gate_val[:, None]
            h = h + y.reshape(b, sq, d).to(h.dtype)
    y = _rms_norm(h, params["ln_f"])
    logits = torch.einsum("bsd,dv->bsv", y, params["unembed"]).float()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
    return nll.mean()
