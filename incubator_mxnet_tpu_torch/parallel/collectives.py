"""Collectives over a process group: the port of the JAX package's
``incubator_mxnet_tpu/parallel/collectives.py``.

The JAX module has two levels: aliases of ``lax`` collectives for use
inside a traced SPMD program, and eager host-level helpers. In the port
every collective is a ``torch.distributed`` call on tensors of the
rank's own device (NCCL on the card, gloo on the CPU), and the same
functions serve both uses: inside a captured step graph (NCCL
collectives capture into CUDA graphs) and eagerly from the kvstore.
``group`` None is the default (world) group. In a process with no
process group every reduction is the identity, as in the JAX package; a
group of one rank runs the collective (NCCL's one-rank copy or scale),
which leaves the values as they are.

- ``all_reduce_mean_``, ``reduce_scatter``, ``all_gather``: the step's
  gradient reductions (mean by ``ReduceOp.AVG`` on NCCL; gloo has no AVG,
  so a sum and one division there);
- ``ring_allreduce_flat``: a ring of ``send`` / ``recv`` (reduce-scatter
  pass, then all-gather pass) through ``ring_hop``;
- ``ppermute``, ``psum``, ``gather_tiles``: the collectives of the
  sequence and tensor-parallel forward, with autograd (each backward the
  forward's adjoint: a hop back, a sum, a reduce-scatter);
- ``int8_bucket_allreduce``: one global amax (``all_reduce(MAX)``), int32
  code sum, dequantize; a non-finite member poisons every output;
- ``host_allreduce`` (``compression="bf16"`` too) and the 2-bit codec
  (``quantize_2bit`` / ``host_allreduce_2bit``, error-feedback residual);
- ``GradBucket``, ``plan_grad_buckets``, ``BucketSchedule`` (pure Python,
  the JAX module's own), ``host_broadcast`` and ``host_barrier``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["group_size", "all_reduce_mean_", "reduce_scatter",
           "all_gather", "ring_allreduce_flat", "ring_hop", "ppermute",
           "psum", "gather_tiles", "int8_bucket_allreduce",
           "host_allreduce", "quantize_2bit", "host_allreduce_2bit",
           "GradBucket", "plan_grad_buckets", "BucketSchedule",
           "bucket_limit", "host_broadcast", "host_barrier"]


# the names torch >= 2.12 prefers, falling back to the older spellings
_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_size(group=None) -> int:
    """Ranks in ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if _grouped() else 1


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_reduce_mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` replaced in place by its mean over ``group``; returns it."""
    if not _grouped():
        return t
    n = group_size(group)
    if _nccl(group):
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)
    return t


def reduce_scatter(x: torch.Tensor, group=None, scatter_dimension: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``group`` (``op`` 'sum' or 'mean') and return this
    rank's tile of ``scatter_dimension`` (the reduce half of a ring
    all-reduce; the fsdp gradient reduction)."""
    if not _grouped():
        return x.clone()
    n = group_size(group)
    d = scatter_dimension % x.dim()
    src = x.movedim(d, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if op == "mean" and _nccl(group):
        _scatter_single(out, src, op=dist.ReduceOp.AVG,
                                   group=group)
    else:
        _scatter_single(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
        if op == "mean":
            out.div_(n)
    return out.movedim(0, d)


def all_gather(x: torch.Tensor, group=None, axis: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``axis`` in rank order (written
    into ``out`` when given)."""
    n = group_size(group)
    d = axis % x.dim()
    if not _grouped():
        if out is None:
            return x.clone()
        out.copy_(x)
        return out
    src = x.movedim(d, 0).contiguous()
    direct = out is not None and d == 0 and out.is_contiguous()
    buf = out if direct else torch.empty(
        (src.shape[0] * n,) + tuple(src.shape[1:]), dtype=x.dtype,
        device=x.device)
    _gather_single(buf, src, group=group)
    if direct:
        return out
    full = buf.movedim(0, d)
    if out is None:
        return full
    out.copy_(full)
    return out


def ring_allreduce_flat(flat: torch.Tensor, group=None,
                        axis_size: Optional[int] = None) -> torch.Tensor:
    """Chunked ring all-reduce (sum) of a flat buffer over ``group`` by
    ``send`` / ``recv`` to the ring's neighbours: a reduce-scatter pass,
    after which rank ``r`` holds the full sum of chunk ``(r + 1) % s``,
    then an all-gather pass. At two ranks each chunk's sum is one
    commutative add, so the result is bitwise the all-reduce's."""
    s = group_size(group) if axis_size is None else int(axis_size)
    if s == 1:
        return flat
    n = flat.numel()
    chunk = -(-n // s)
    buf = torch.zeros(chunk * s, dtype=flat.dtype, device=flat.device)
    buf[:n] = flat
    buf = buf.reshape(s, chunk)
    r = dist.get_rank(group)

    def hop(t):
        return ring_hop(t, group)

    partial = buf[r].clone()
    for t in range(s - 1):
        partial = hop(partial) + buf[(r - t - 1) % s]
    owned = (r + 1) % s
    out = torch.empty_like(buf)
    out[owned] = partial
    for t in range(s - 1):
        partial = hop(partial)
        out[(owned - t - 1) % s] = partial
    return out.reshape(-1)[:n]


def _peer(group, i: int) -> int:
    """The global rank of ``group``'s rank ``i``."""
    return i if group is None else dist.get_global_rank(group, i)


def ring_hop(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """``t`` sent to the rank ``shift`` places ahead on ``group``'s ring
    while the one ``shift`` places behind is received (a ``lax.ppermute``
    by ``shift``): one send and one receive in one
    ``dist.batch_isend_irecv``. ``t`` itself on a ring of one."""
    s = group_size(group)
    if s == 1:
        return t
    r = dist.get_rank(group)
    t = t.contiguous()
    got = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, _peer(group, (r + shift) % s), group),
        dist.P2POp(dist.irecv, got, _peer(group, (r - shift) % s), group)])
    for q in reqs:
        q.wait()
    return got


# ----------------------------------------------------------------------- #
# differentiable collectives (the traced ``lax`` ones of the JAX module):
# each backward is its forward's adjoint over the ranks, so a rank's
# gradients are those of the SUM of every rank's loss (see parallel/spmd.py)
# ----------------------------------------------------------------------- #
class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_hop(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_hop(g, ctx.group, -ctx.shift), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        if _grouped():
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if _grouped():
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.axis, op="sum"), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """``ring_hop`` with autograd: the gradient hops back."""
    return _PPermute.apply(x, group, shift)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, with autograd (the
    backward sums the gradients over ``group``)."""
    return _PSum.apply(x, group)


def gather_tiles(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """The ranks' tiles of ``x`` concatenated on ``axis`` in rank order,
    with autograd (the backward reduce-scatters the gradient: each rank
    gets the sum over the ranks of its tile's)."""
    return _GatherTiles.apply(x, group, axis)


def int8_bucket_allreduce(vals, group=None):
    """EQuARX-style quantized all-reduce (sum) of one gradient bucket:
    ONE symmetric scale from the GLOBAL amax (``all_reduce(MAX)``), the
    int8 codes summed as int32, dequantized. Returns the reduced members
    in order, each in its input dtype.

    A non-finite member poisons the amax (a NaN amax is sent as +inf, so
    no backend's max can drop it), the scale, and so every dequantized
    member: the guard reading the dequantized gradients vetoes the step
    without a second reduction."""
    from ..ops.quantization import (dequantize_symmetric,
                                    quantize_symmetric, symmetric_scale)
    amax = torch.stack([v.float().abs().max() for v in vals]).max()
    amax = torch.where(torch.isnan(amax), torch.full_like(amax, torch.inf),
                       amax)
    if _grouped():
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = symmetric_scale(amax)
    codes = [quantize_symmetric(v.float(), scale).to(torch.int32)
             for v in vals]
    if _grouped():
        flat = torch.cat([c.reshape(-1) for c in codes])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        codes = [c.reshape(v.shape) for c, v in zip(
            flat.split([v.numel() for v in vals]), vals)]
    return [dequantize_symmetric(c, scale).to(v.dtype)
            for c, v in zip(codes, vals)]


# ----------------------------------------------------------------------- #
# host-level collectives (the kvstore's transport)
# ----------------------------------------------------------------------- #
def host_allreduce(x: torch.Tensor, op: str = "sum",
                   compression: Optional[str] = None,
                   group=None) -> torch.Tensor:
    """Cross-process sum of ``x`` (every rank gets the elementwise sum);
    the identity in one process. ``compression="bf16"`` on an f32 input
    sends bf16 (half the bytes) and sums the gathered contributions in
    f32, in rank order, as the JAX helper does."""
    if op != "sum":
        raise ValueError(f"unsupported host_allreduce op {op!r}")
    if not _grouped():
        return x
    n = group_size(group)
    if compression == "bf16" and x.dtype == torch.float32:
        gathered = torch.empty(n * x.numel(), dtype=torch.bfloat16,
                               device=x.device)
        _gather_single(gathered, x.to(torch.bfloat16)
                                    .reshape(-1), group=group)
        return gathered.view((n,) + tuple(x.shape)).float().sum(0)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


# ----------------------------------------------------------------------- #
# 2-bit threshold gradient compression (reference:
# src/kvstore/gradient_compression.cc, the dist_sync wire format). Codes:
# 0 -> 0, 1 -> +threshold, 2 -> -threshold; four codes a byte, so the hop
# carries N/4 bytes instead of 4N. The quantization error stays in a
# per-key residual added back before the next quantization (error
# feedback); without it the scheme does not converge.
# ----------------------------------------------------------------------- #

def _pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 codes in {0, 1, 2} -> (ceil(N/4),) packed uint8 (the
    four fields are disjoint, so the sum of shifted fields is their
    bitwise or)."""
    n = codes.shape[0]
    pad = (-n) % 4
    c = torch.cat([codes, codes.new_zeros(pad)]).reshape(-1, 4) \
        .to(torch.int32)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=codes.device)
    return (c << shifts[None, :]).sum(1).to(torch.uint8)


def _unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(N/4),) packed uint8 -> (N,) uint8 codes."""
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    c = (packed.to(torch.int32)[:, None] >> shifts[None, :]) & 3
    return c.reshape(-1)[:n].to(torch.uint8)


def quantize_2bit(x: torch.Tensor, residual: Optional[torch.Tensor],
                  threshold: float):
    """Quantize ``x + residual`` to 2-bit codes; returns (packed uint8,
    dequantized, new residual). The cut points sit at +-threshold/2, so
    the dequantized value is the nearest of {-threshold, 0,
    +threshold}."""
    c = x if residual is None else x + residual
    one = torch.ones((), dtype=torch.uint8, device=x.device)
    codes = torch.where(c >= threshold / 2, one,
                        torch.where(c <= -threshold / 2, one * 2, one * 0))
    th = torch.full((), float(threshold), dtype=torch.float32,
                    device=x.device)
    deq = torch.where(codes == 1, th,
                      torch.where(codes == 2, -th, th * 0)).to(x.dtype)
    return _pack_2bit(codes.reshape(-1)), deq, c - deq


def host_allreduce_2bit(x: torch.Tensor, residual: Optional[torch.Tensor],
                        threshold: float = 0.5, group=None):
    """Cross-process sum with 2-bit wire compression: each rank quantizes
    its contribution (with its own residual), the packed codes (N/4
    bytes) are gathered, and every rank sums the dequantized
    contributions. Returns (reduced, new residual). In one process the
    push still quantizes (the numerics contract)."""
    packed, deq, new_res = quantize_2bit(x, residual, threshold)
    if not _grouped():
        return deq, new_res
    n = group_size(group)
    gathered = torch.empty(n * packed.numel(), dtype=torch.uint8,
                           device=packed.device)
    _gather_single(gathered, packed, group=group)
    codes = torch.stack([_unpack_2bit(p, x.numel())
                         for p in gathered.view(n, -1)])
    signs = torch.where(codes == 1, 1.0, torch.where(codes == 2, -1.0, 0.0))
    total = signs.sum(0).reshape(x.shape) * threshold
    return total.to(x.dtype), new_res


# ----------------------------------------------------------------------- #
# deterministic gradient-bucket schedule (the JAX module's, pure Python).
#
# An overlapped all-reduce issues a bucket's collective DURING backward,
# so the issue order is a correctness surface: a collective is a
# rendezvous, and two processes issuing buckets in different orders
# deadlock. The plan below is a pure function of (member indices, sizes,
# dtypes, byte limit), identical on every process, and buckets are
# ISSUED strictly in plan order, gated on readiness. Members are packed
# in REVERSE parameter order because backward finalizes the last layers'
# gradients first.
# ----------------------------------------------------------------------- #

class GradBucket:
    """One dtype bucket of the overlap plan: a deterministic key plus the
    member parameter indices (in packing order)."""

    __slots__ = ("key", "dtype", "indices", "nbytes")

    def __init__(self, key: str, dtype: str, indices, nbytes: int):
        self.key = key
        self.dtype = dtype
        self.indices = tuple(indices)
        self.nbytes = int(nbytes)

    def __repr__(self):
        return (f"GradBucket({self.key!r}, n={len(self.indices)}, "
                f"{self.nbytes}B)")


def plan_grad_buckets(members, limit_bytes: int,
                      key_prefix: str = "__grad_bucket_",
                      reverse: bool = True):
    """Deterministic bucket plan over ``members`` =
    ``[(param_idx, size_elems, itemsize, dtype_str)]`` — THE one
    audited packing, shared by the serial bucketed pushpull
    (``reverse=False``: forward param order, the serial key format) and
    the overlapped issue plan (``reverse=True``).

    Groups by dtype (sorted), packs each dtype's members in param-index
    order — REVERSE for the overlap plan, because backward finalizes
    the deepest layers first — into <= ``limit_bytes`` buckets, and
    orders the buckets deepest-parameter-first (reverse) or
    shallowest-first (forward). Keys follow the serial bucket-key format
    (dtype + running id + crc of the member composition; the overlap
    plan's ids carry an ``ov`` tag since its compositions differ) so
    dist-mode compression residuals stay coherent per composition."""
    import zlib
    by_dtype = {}
    for idx, size, itemsize, dt in members:
        by_dtype.setdefault(str(dt), []).append((int(idx), int(size),
                                                 int(itemsize)))
    tag = "ov" if reverse else ""
    buckets = []
    for dt in sorted(by_dtype):
        entries = sorted(by_dtype[dt],
                         key=(lambda e: -e[0]) if reverse
                         else (lambda e: e[0]))
        start, bucket_id = 0, 0
        while start < len(entries):
            end, nbytes = start, 0
            while end < len(entries):
                sz = entries[end][1] * entries[end][2]
                if end > start and nbytes + sz > limit_bytes:
                    break
                nbytes += sz
                end += 1
            chunk = entries[start:end]
            comp = zlib.crc32(",".join(
                f"{i}:{n}" for i, n, _ in chunk).encode())
            buckets.append(GradBucket(
                f"{key_prefix}{dt}_{tag}{bucket_id}_{comp:08x}", dt,
                [i for i, _, _ in chunk], nbytes))
            start = end
            bucket_id += 1
    if reverse:
        buckets.sort(key=lambda b: (-max(b.indices), b.dtype))
    else:
        buckets.sort(key=lambda b: (min(b.indices), b.dtype))
    return buckets


def bucket_limit() -> int:
    """The byte limit of a gradient bucket: ``MXTPU_GRAD_BUCKET_BYTES``,
    else ``MXTPU_GRAD_BUCKET_MB`` (default 32) MiB."""
    from ..base import getenv_int
    return getenv_int("MXTPU_GRAD_BUCKET_BYTES", 0) or \
        getenv_int("MXTPU_GRAD_BUCKET_MB", 32) * (1 << 20)


class BucketSchedule:
    """Readiness-gated, plan-ordered issue schedule over a bucket plan.

    ``mark_ready(param_idx)`` records one member gradient as final and
    returns the list of buckets now clear to issue: the next bucket in
    plan order issues only when every member is ready AND every earlier
    bucket has issued — so the observed issue order is the plan order by
    construction (the cross-process deadlock-freedom contract above).
    ``drain()`` returns the still-unissued tail (the end-of-backward
    flush). ``issued`` is the per-round ledger of issued bucket keys."""

    def __init__(self, buckets):
        self.buckets = list(buckets)
        self._member_of = {}
        for b in self.buckets:
            for i in b.indices:
                self._member_of[i] = b
        self._pending = {b.key: len(b.indices) for b in self.buckets}
        self._cursor = 0
        self.issued = []

    @property
    def order(self):
        return [b.key for b in self.buckets]

    def reset_round(self):
        self._pending = {b.key: len(b.indices) for b in self.buckets}
        self._cursor = 0
        self.issued = []

    def mark_ready(self, param_idx: int):
        b = self._member_of.get(param_idx)
        if b is None:
            return []
        n = self._pending.get(b.key, 0)
        if n > 0:
            self._pending[b.key] = n - 1
        ready = []
        while self._cursor < len(self.buckets) and \
                self._pending[self.buckets[self._cursor].key] == 0:
            nxt = self.buckets[self._cursor]
            self._cursor += 1
            self.issued.append(nxt.key)
            ready.append(nxt)
        return ready

    def drain(self):
        tail = self.buckets[self._cursor:]
        self._cursor = len(self.buckets)
        for b in tail:
            self.issued.append(b.key)
        return tail


def host_broadcast(x: torch.Tensor, root: int = 0,
                   group=None) -> torch.Tensor:
    """``x`` of the root rank on every rank (the reference's init-time
    weight broadcast through kvstore init / pull); a copy."""
    if not _grouped():
        return x
    out = x.clone()
    dist.broadcast(out, src=root, group=group)
    return out


def host_barrier(tag: str = "barrier", group=None):
    """Cross-process barrier (reference: ps-lite ``Barrier``)."""
    if _grouped():
        dist.barrier(group=group)
