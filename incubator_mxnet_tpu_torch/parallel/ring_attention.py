"""Ring attention: exact attention over a sequence split across ranks, the
port of the JAX package's ``incubator_mxnet_tpu/parallel/ring_attention.py``.

The sequence is split over the mesh's ``sp`` axis: each rank holds one
(B, T/sp, H, D) block of q, k and v (its tile of the batch, its block of
the sequence). K and V blocks go round the ring, one hop a step
(``collectives.ppermute``: ``dist.batch_isend_irecv`` to the next rank and
from the previous one, where the JAX module has ``lax.ppermute``), while
the rank's queries accumulate attention over each block it holds, so
attention over ``sp x T_blk`` keys runs with one block's memory a rank.
The JAX ``shard_map`` wrapper has no counterpart: a rank's code sees its
blocks already.

Two engines, as in JAX:

  - the plain streaming ring (``ring_attention_block`` /
    ``ring_self_attention``: the flash recurrence in plain torch,
    differentiable through autograd, the hops' gradients hopping back): a
    global ``valid_length`` (B,) masks keys at global positions past it,
    ``causal`` masks by global position, and a fully masked row is zero;
  - the flash-kernel ring (``ring_flash_attention_block`` /
    ``ring_flash_attention``): each step is one ``block_attn_lse`` launch
    (``ops/flash_attention.py``; the CUDA kernels on the card, their plain
    versions on the CPU) whose partial ``(out, lse)`` is merged by the
    logsumexp rule (``_merge_partials``); the diagonal block is causal
    when the ring is, every other block is all or nothing by
    ``valid_len`` (``_block_vl``: a block gated off launches with
    ``valid_len`` 0 for the whole batch, and gives zero out, lse -1e30 and
    exactly zero gradients). Its backward is a second ring: each step runs
    one block's backward (the dq launch, which computes Δ from the MERGED
    output, then dk/dv) against the GLOBAL lse, dq accumulates on the rank
    and each block's dk / dv accumulators ride the ring with the block,
    one last hop bringing them home.

One ring step is a function of one rank's state (``ring_step``,
``flash_fwd_step``, ``flash_bwd_step``). One loop of each kind
(``plain_ring``, ``flash_ring_fwd``, ``flash_ring_bwd``) runs the steps of
the ranks this process holds and takes the hop as an argument: the
distributed entry points hold one rank and hop over the sp group; with
the defaults a process holds every rank of a ring and the hop is a
rotation of the lists (``rotate``: the one-process tests, and the card's
``sequence`` phase in ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..base import MXNetError
from ..ops import flash_attention as _fa
from . import collectives as _coll
from . import mesh as _mesh

__all__ = ["ring_self_attention", "ring_attention_block",
           "ring_flash_attention", "ring_flash_attention_block",
           "active_ring_mesh", "ring_step", "flash_fwd_step",
           "flash_bwd_step", "plain_ring", "flash_ring_fwd",
           "flash_ring_bwd", "rotate"]

_NEG_INF = -1e30


def active_ring_mesh(seq_len: int):
    """The model-side gate for sequence-parallel attention: the active
    SPMD mesh (``spmd.activation_sharding_scope``) when it has an ``sp``
    axis of size > 1 that divides ``seq_len`` (the GLOBAL length), else
    None."""
    from .spmd import active_mesh
    mesh = active_mesh()
    if mesh is None:
        return None
    sp = _mesh.axis_sizes(mesh)["sp"]
    if sp <= 1 or seq_len % sp:
        return None
    return mesh


def _ct(dtype):
    return torch.promote_types(dtype, torch.float32)


def _stream_block(q, k, v, acc, row_max, row_sum, mask, scale=1.0):
    """One flash-attention accumulation step. q (B, Tq, H, D); k / v
    (B, Tk, H, D); acc (B, Tq, H, D); row_max / row_sum (B, Tq, H) in the
    computation type; mask additive, (Tq, Tk) shared or (B, Tq, Tk), or
    None. The products read the operands in their dtype, accumulated in
    f32 (or wider), the scale on the f32 scores, p cast to v's dtype
    before the value product, as in JAX."""
    ct = acc.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    if mask is not None:
        scores = scores + (mask[None, None] if mask.dim() == 2
                           else mask[:, None])
    blk_max = scores.amax(dim=-1).permute(0, 2, 1)          # (B, Tq, H)
    new_max = torch.maximum(row_max, blk_max)
    corr = torch.exp(row_max - new_max)
    p = torch.exp(scores - new_max.permute(0, 2, 1)[..., None])
    blk_out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(ct),
                           v.to(ct))
    blk_sum = p.sum(dim=-1).permute(0, 2, 1)
    return acc * corr[..., None] + blk_out, new_max, \
        row_sum * corr + blk_sum


def ring_init(q):
    """A rank's empty accumulators for its queries (B, Tq, H, D)."""
    B, Tq, H, _ = q.shape
    ct = _ct(q.dtype)
    return (torch.zeros(q.shape, dtype=ct, device=q.device),
            torch.full((B, Tq, H), _NEG_INF, dtype=ct, device=q.device),
            torch.zeros((B, Tq, H), dtype=ct, device=q.device))


def ring_step(q, k, v, state, step: int, n: int, size: int,
              valid_length=None, causal: bool = False, scale=None):
    """Step ``step`` of the plain ring on rank ``n`` of ``size``: ``k`` /
    ``v`` are the block rank ``(n - step) % size`` started with (after
    ``step`` hops). Returns the new ``state`` (``ring_init``'s)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    sc = D ** -0.5 if scale is None else float(scale)
    src = (n - step) % size
    dev = q.device
    ct = state[0].dtype
    pos_q = n * Tq + torch.arange(Tq, device=dev)
    pos_k = src * Tq + torch.arange(Tk, device=dev)
    zero = torch.zeros((), dtype=ct, device=dev)
    neg = torch.full((), _NEG_INF, dtype=ct, device=dev)
    mask = None
    if causal:
        mask = torch.where(pos_k[None, :] <= pos_q[:, None], zero, neg)
    if valid_length is not None:
        vl_mask = torch.where(
            pos_k[None, :] < valid_length.to(dev).long()[:, None], zero,
            neg)                                              # (B, Tk)
        vl_mask = vl_mask[:, None].expand(B, Tq, Tk)
        mask = vl_mask if mask is None else mask[None] + vl_mask
    return _stream_block(q, k, v, *state, mask, scale=sc)


def ring_finish(q, state):
    """A rank's output block from its accumulators: normalized, a fully
    masked row (its running max never rose above the -1e30 floor) zero,
    in q's dtype."""
    acc, row_max, row_sum = state
    out = acc / torch.clamp(row_sum[..., None], min=1e-30)
    out = torch.where((row_max > _NEG_INF / 2)[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.to(q.dtype)


def _sp_group(mesh, axis_name):
    if mesh is None:
        from .spmd import active_mesh
        mesh = active_mesh()
    if mesh is None:
        mesh = _mesh.default_mesh()
    if axis_name not in mesh.mesh_dim_names:
        raise MXNetError(f"mesh has no axis {axis_name!r}")
    return mesh, _mesh.axis_group(mesh, axis_name)


def _ring_coords(group):
    size = _coll.group_size(group)
    return (torch.distributed.get_rank(group) if size > 1 else 0), size


def rotate(blocks: List) -> List:
    """One hop of a ring whose every rank this process holds (rank n's
    block at index n): rank n receives rank n - 1's block."""
    return blocks[-1:] + blocks[:-1]


def _group_hop(group, send):
    """The hop of a process holding one rank of ``group``'s ring:
    ``send`` (``collectives.ring_hop``, or ``ppermute`` where autograd
    must see it) on the one block."""
    return lambda blocks: [send(blocks[0], group)]


def _ring_ranks(qs, ranks, size):
    return (range(len(qs)) if ranks is None else ranks,
            len(qs) if size is None else size)


def plain_ring(qs: List, ks: List, vs: List, valid_length=None,
               causal: bool = False, scale=None, *, ranks=None, size=None,
               hop=rotate) -> List:
    """The plain ring's loop over the ranks ``ranks`` (default: all
    ``size`` = ``len(qs)`` of them) whose (B, T_blk, H, D) blocks this
    process holds, ``hop`` moving a list of their blocks one step round
    the ring. Differentiable through autograd when ``hop`` is. Returns
    the ranks' output blocks."""
    ranks, size = _ring_ranks(qs, ranks, size)
    states = [ring_init(q) for q in qs]
    for step in range(size):
        if step:
            ks, vs = hop(ks), hop(vs)
        states = [ring_step(q, k, v, st, step, n, size, valid_length,
                            causal, scale)
                  for q, k, v, st, n in zip(qs, ks, vs, states, ranks)]
    return [ring_finish(q, st) for q, st in zip(qs, states)]


def ring_attention_block(q, k, v, valid_length=None, axis_name: str = "sp",
                         causal: bool = False, scale: Optional[float] = None,
                         *, group=None):
    """A rank's plain ring attention over ``group`` (its ranks in ring
    order; default: the active mesh's ``axis_name`` group). q / k / v are
    this rank's blocks (B, T_blk, H, D); ``valid_length`` (B,) GLOBAL key
    lengths. Differentiable: each hop's gradient hops back. Returns this
    rank's output block."""
    if group is None:
        _, group = _sp_group(None, axis_name)
    n, size = _ring_coords(group)
    return plain_ring([q], [k], [v], valid_length, causal, scale,
                      ranks=[n], size=size,
                      hop=_group_hop(group, _coll.ppermute))[0]


def ring_self_attention(q, k, v, mesh=None, axis_name: str = "sp",
                        causal: bool = False, scale: Optional[float] = None,
                        batch_axis="dp", valid_length=None):
    """Exact self-attention with the sequence split over ``axis_name``:
    q / k / v are this rank's (B, T/sp, H, D) blocks (the batch already
    this rank's tile, so ``batch_axis`` moves nothing), ``valid_length``
    (B,) global key lengths. Returns this rank's block; differentiable."""
    _, group = _sp_group(mesh, axis_name)
    return ring_attention_block(q, k, v, valid_length, axis_name, causal,
                                scale, group=group)


# --------------------------------------------------------------------- #
# ring attention with the flash kernels as the per-block engine; the
# steps work in (B, H, T, D), the kernels' layout
# --------------------------------------------------------------------- #

def _merge_partials(o1, lse1, o2, lse2):
    """Associatively combine two attention partials carrying their
    logsumexp (the flash merge rule): (B, H, T, D) / (B, H, T); the
    output in f32."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    den = torch.clamp(w1 + w2, min=1e-38)
    out = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / \
        den[..., None]
    return out, m + torch.log(den)


def _block_vl(step: int, n: int, size: int, B: int, Tq: int, causal: bool,
              device):
    """The key lengths of ring step ``step`` on rank ``n``: the block held
    is ``(n - step) % size``'s, under causality fully visible when it
    precedes ours and fully masked otherwise (0 for the whole batch)."""
    allowed = (not causal) or (n - step) % size < n
    return torch.full((B,), Tq if allowed else 0, dtype=torch.int32,
                      device=device)


def flash_fwd_step(q, k, v, out, lse, step: int, n: int, size: int,
                   causal: bool = False, scale=None):
    """Step ``step`` of the flash ring's forward on rank ``n``: q / k / v
    (B, H, T_blk, D) contiguous, ``k`` / ``v`` the block rank
    ``(n - step) % size`` started with; one ``block_attn_lse`` launch
    (the diagonal block, step 0, causal when the ring is; the others
    gated by ``_block_vl``) merged into ``(out, lse)`` (None at step 0).
    Returns the merged ``(out f32, lse)``."""
    B, _, Tq, _ = q.shape
    vl = _block_vl(step, n, size, B, Tq, causal and step > 0, q.device)
    o_b, lse_b = _fa.block_fwd(q, k, v, vl, causal and step == 0, scale)
    if step == 0:
        return o_b.float(), lse_b
    return _merge_partials(out, lse, o_b, lse_b)


def flash_bwd_step(q, k, v, out, lse, dout, dq, dk, dv, step: int, n: int,
                   size: int, causal: bool = False, scale=None):
    """Step ``step`` of the flash ring's backward on rank ``n``: one
    block's backward (``block_attn_bwd``: dq with Δ from the merged
    ``out``, then dk/dv) against the GLOBAL ``lse``, added into the rank's
    dq and into the f32 ``dk`` / ``dv`` accumulators of the block it holds
    (None at step 0). Returns ``(dq, dk, dv)`` in f32."""
    B, _, Tq, _ = q.shape
    vl = _block_vl(step, n, size, B, Tq, causal and step > 0, q.device)
    dq_b, dk_b, dv_b = _fa.block_attn_bwd(q, k, v, vl, out, lse, dout,
                                          causal and step == 0, scale)
    if step == 0:
        return dq_b.float(), dk_b.float(), dv_b.float()
    return dq + dq_b.float(), dk + dk_b.float(), dv + dv_b.float()


def flash_ring_fwd(qs: List, ks: List, vs: List, causal: bool = False,
                   scale=None, *, ranks=None, size=None, hop=rotate):
    """The flash ring's forward loop over the ranks ``ranks`` (as
    ``plain_ring``'s): (B, H, T_blk, D) blocks in, each rank's
    ``(out, lse)`` out, out in q's dtype (as the ring returns it and its
    backward reads it)."""
    ranks, size = _ring_ranks(qs, ranks, size)
    res = [(None, None)] * len(qs)
    for step in range(size):
        if step:
            ks, vs = hop(ks), hop(vs)
        res = [flash_fwd_step(q, k, v, *r, step, n, size, causal, scale)
               for q, k, v, r, n in zip(qs, ks, vs, res, ranks)]
    return [(o.to(q.dtype), lse) for q, (o, lse) in zip(qs, res)]


def flash_ring_bwd(qs: List, ks: List, vs: List, outs: List, lses: List,
                   douts: List, causal: bool = False, scale=None, *,
                   ranks=None, size=None, hop=rotate):
    """The flash ring's backward loop (the second ring) over the ranks
    ``ranks``: each rank's ``(dq, dk, dv)`` in the inputs' dtypes. The dk
    / dv accumulators hop with their blocks, and one last hop brings them
    home."""
    ranks, size = _ring_ranks(qs, ranks, size)
    dqs = dks = dvs = [None] * len(qs)
    for step in range(size):
        if step:
            ks, vs, dks, dvs = hop(ks), hop(vs), hop(dks), hop(dvs)
        grads = [flash_bwd_step(q, k, v, o, lse, do, dq, dk, dv, step, n,
                                size, causal, scale)
                 for q, k, v, o, lse, do, dq, dk, dv, n in zip(
                     qs, ks, vs, outs, lses, douts, dqs, dks, dvs, ranks)]
        dqs, dks, dvs = (list(g) for g in zip(*grads))
    dks, dvs = hop(dks), hop(dvs)
    return [(dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))
            for q, dq, dk, dv in zip(qs, dqs, dks, dvs)]


class _RingFlash(torch.autograd.Function):
    """The flash ring on this rank over ``group``: (B, T_blk, H, D) in and
    out; the backward is the second ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, size = _ring_coords(group)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        (out, lse), = flash_ring_fwd(
            [qt], [kt], [vt], causal, scale, ranks=[n], size=size,
            hop=_group_hop(group, _coll.ring_hop))
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, out, lse = ctx.saved_tensors
        n, size = _ring_coords(ctx.group)
        gt = g.transpose(1, 2).to(qt.dtype).contiguous()
        (dq, dk, dv), = flash_ring_bwd(
            [qt], [kt], [vt], [out], [lse], [gt], ctx.causal, ctx.scale,
            ranks=[n], size=size, hop=_group_hop(ctx.group, _coll.ring_hop))
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def ring_flash_attention_block(q, k, v, axis_name: str = "sp",
                               causal: bool = False,
                               scale: Optional[float] = None, *,
                               group=None):
    """Ring attention with the flash kernels per block on this rank over
    ``group`` (default: the active mesh's ``axis_name`` group): q / k / v
    this rank's (B, T_blk, H, D) blocks; returns its output block.
    Forward: each step one ``block_attn_lse`` launch merged by its
    logsumexp; backward: the second ring (see the module's docstring)."""
    if group is None:
        _, group = _sp_group(None, axis_name)
    return _RingFlash.apply(q, k, v, group, bool(causal), scale)


def ring_flash_attention(q, k, v, mesh=None, axis_name: str = "sp",
                         causal: bool = False, scale: Optional[float] = None,
                         batch_axis="dp"):
    """``ring_self_attention`` with the flash kernels as the per-block
    engine (the CUDA kernels on the card, their plain versions on the
    CPU); the same contract: this rank's (B, T/sp, H, D) blocks,
    differentiable."""
    _, group = _sp_group(mesh, axis_name)
    return ring_flash_attention_block(q, k, v, axis_name, causal, scale,
                                      group=group)
