"""Ragged paged-KV attention for serving: decode, chunked prefill and the
speculative verify window, over raw or quantized page pools.

K/V live in a shared page pool per layer,

    k_pool / v_pool : (num_pages, H, page_size, D)

and each slot owns an ordered page-table row. Page 0 is the NULL page:
never allocated, every dead page-table entry points at it, and every
read of it is masked by the slot's length.

Three functions, each with a hand-written CUDA kernel (``csrc/``) and a
plain PyTorch version in this module:

  - ``ragged_paged_attention`` (decode): one query per slot over that
    slot's live pages — ``csrc/ragged_decode.cu``, the port of the JAX
    package's ``_ragged_kernel`` (for bf16 at D = 64 the tensor-core body
    of the prefill and verify kernels, a decode step being a one-row
    verify window with no draft), which takes its key-split plan from
    ``decode_plan``;
  - ``ragged_prefill_attention`` (chunked prefill): C queries of one
    slot at positions ``q_start + i`` over the paged prefix plus the
    causal part of the chunk — ``csrc/ragged_prefill.cu``, the port of
    ``_ragged_prefill_kernel`` (tensor cores for bf16 at D = 64), which
    reads the chunk's span ``[q_start, n_real]`` on the device, as the
    Pallas kernel's ``qinfo``, and takes its key-split plan from
    ``prefill_plan``;
  - ``ragged_verify_attention`` (speculative verify): W queries per slot
    at positions ``lengths - 1 + r``, causal inside the window —
    ``csrc/ragged_verify.cu``, the port of ``_ragged_verify_kernel``
    (the prefill kernel's tensor-core body for bf16 at D = 64 and W <=
    64, with one slot a grid row), which takes its key-split plan from
    ``verify_plan``.

Each takes optional ``k_scale`` / ``v_scale`` (P,) f32 per-page scales:
given, the pools hold int8 or float8_e4m3fn codes and are dequantized
where they are read (the plain versions at the gather, the kernels where
they stage a page into shared memory); q stays f32 or bf16.

Dispatch is by device only: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor runs the plain version. There is no
fallback between the two. All share the masked-row contract: masked
positions are selected out of V, the masked score is -1e30, a slot with
nothing to attend emits exactly zero, and a NaN propagates (for a
quantized pool the page scale is the NaN channel).

``LAUNCHES`` counts kernel launches per kernel, the quantized variants
under their own ``_q`` keys; the wrappers add one only where they
launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build

_NEG_INF = -1e30

__all__ = ["ragged_paged_attention", "ragged_attention_reference",
           "ragged_prefill_attention", "ragged_prefill_reference",
           "chunk_span",
           "ragged_verify_attention", "ragged_verify_reference",
           "PrefillPlan", "prefill_plan", "VerifyPlan", "verify_plan",
           "DecodePlan", "decode_plan", "LAUNCHES", "reset_launch_counts"]

LAUNCHES = {"ragged_decode": 0, "ragged_prefill": 0, "ragged_verify": 0,
            "ragged_decode_q": 0, "ragged_prefill_q": 0,
            "ragged_verify_q": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.int8: 2, torch.float8_e4m3fn: 3}     # quantized payloads
_MAX_HEAD_DIM = 256
_MMA_D = 64            # head dim of the tensor-core body
_MMA_TILE = 64         # its query rows per tile and keys per staged tile
_CORE_SPLIT_KEYS = 64  # keys per split of the CUDA-core body
_CORE_ROWS = 16        # query rows per block of the CUDA-core body
_MAX_CLUSTER = 16      # tensor-core body: a head's splits form one cluster
_VERIFY_BLOCKS_PER_SM = 3   # verify blocks an SM holds (registers, smem)
_PREFILL_BLOCKS_PER_SM = 3  # prefill blocks an SM holds: verify's body at
                            # one 64-row query tile
_DECODE_BLOCKS_PER_SM = 4   # decode blocks an SM holds: 120 registers on
                            # code pools (96 raw), ~39 KB of smem
H100_SMS = 132


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path, and the oracle the kernels are
# held against on the card)
# --------------------------------------------------------------------- #

def _take_pages(pool, idx):
    """``pool[idx]``, through a byte view for float8 pools (float8
    indexing is not implemented on every device)."""
    if pool.dtype in (torch.float32, torch.bfloat16, torch.int8):
        return pool[idx]
    return pool.view(torch.uint8)[idx].view(pool.dtype)


def _gather_window(pool, page_table, scale=None):
    """(S, H, K, D) dense window of each slot's pages, K = max_pages *
    page_size. ``scale`` (P,) dequantizes a code pool at the gather
    (one scale per page), giving f32."""
    S, n_pages = page_table.shape
    _, H, ps, D = pool.shape
    pt = page_table.long()
    g = _take_pages(pool, pt)                    # (S, n_pages, H, ps, D)
    if scale is not None:
        g = g.float() * scale[pt][:, :, None, None, None]
    return g.permute(0, 2, 1, 3, 4).reshape(S, H, n_pages * ps, D)


def _reference_core(q, k, v, lengths, sc):
    """Masked softmax attention over a pre-gathered window, f32
    accumulation. q: (S, H, D); k/v: (S, H, K, D)."""
    K = k.shape[2]
    s = torch.einsum("shd,shkd->shk", q.float(), k.float()) * sc
    valid = torch.arange(K, device=q.device)[None, :] < \
        lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    # select masked positions out of V: a reused page may carry NaN past
    # this slot's length, and 0 * NaN = NaN would leak it
    v = torch.where(valid[:, None, :, None], v.float(), 0.0)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("shk,shkd->shd", p, v) / \
        torch.clamp(l, min=1e-30)[..., None]
    # negated compare: a length-0 slot gives zero, a NaN max propagates
    row_ok = ~(m <= _NEG_INF / 2)
    return torch.where(row_ok[..., None], out, 0.0).to(q.dtype)


def ragged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                               scale=None, k_scale=None, v_scale=None):
    """Plain decode attention: gather each slot's pages to a dense
    window (dequantized when scales are given), mask positions >=
    length, softmax in f32."""
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    k = _gather_window(k_pool, page_table, k_scale)
    v = _gather_window(v_pool, page_table, v_scale)
    return _reference_core(q, k, v, lengths, sc)


def chunk_span(q_start, n_real, C, device):
    """A chunk's ``[start, n_real]`` as the int32 (2,) tensor the prefill
    kernel reads: a span tensor is returned as given (``n_real`` must then
    be None); host ints (``n_real`` default C, within [0, C]; start >= 0)
    are staged onto ``device``."""
    if isinstance(q_start, torch.Tensor):
        if n_real is not None:
            raise MXNetError("ragged prefill: give the chunk as a span "
                             "tensor or as host ints, not both")
        return q_start
    start = int(q_start)
    n = C if n_real is None else int(n_real)
    if not 0 <= n <= C or start < 0:
        raise MXNetError(f"ragged prefill: n_real {n} outside [0, {C}] or "
                         f"q_start {start} < 0")
    return torch.tensor([start, n], dtype=torch.int32, device=device)


def ragged_prefill_reference(q, k_pool, v_pool, page_row, q_start,
                             scale=None, n_real=None, k_scale=None,
                             v_scale=None):
    """Plain chunked-prefill attention for one slot: gather the slot's
    page window, apply the per-query mask ``pos_k <= start + i``, select
    V positions ``>= start + n_real`` out (no live row may read them; on
    a partial chunk they are unwritten and may hold a recycled page's
    NaN), softmax in f32; rows ``>= n_real`` (padding) are exact zeros,
    as the kernel writes them. The chunk is a span tensor ``[start,
    n_real]`` or host ints (``chunk_span``); the span is masked with
    tensor ops, read nowhere on the host."""
    C, H, D = q.shape
    sc = D ** -0.5 if scale is None else scale
    span = chunk_span(q_start, n_real, C, q.device).to(q.device).long()
    start = span[0].clamp(min=0)
    n = span[1].clamp(0, C)
    k = _gather_window(k_pool, page_row[None], k_scale)[0]   # (H, K, D)
    v = _gather_window(v_pool, page_row[None], v_scale)[0]
    K = k.shape[1]
    s = torch.einsum("chd,hkd->chk", q.float(), k.float()) * sc
    pos_k = torch.arange(K, device=q.device)[None, :]
    rows = torch.arange(C, device=q.device)
    pos_q = start + rows[:, None]
    s = torch.where((pos_k <= pos_q)[:, None, :], s, _NEG_INF)
    never_read = torch.arange(K, device=q.device) >= start + n
    v = torch.where(never_read[None, :, None], 0.0, v.float())
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("chk,hkd->chd", p, v) / \
        torch.clamp(l, min=1e-30)[..., None]
    row_ok = ~(m <= _NEG_INF / 2) & (rows < n)[:, None]
    return torch.where(row_ok[..., None], out, 0.0).to(q.dtype)


def ragged_verify_reference(q, k_pool, v_pool, page_table, lengths,
                            scale=None, k_scale=None, v_scale=None):
    """Plain verify attention: query row r of slot s attends
    ``lengths[s] + r`` keys (0 for a dead slot). DELIBERATELY the decode
    core once per row over ONE shared gather rather than a wider einsum:
    row r then runs exactly the decode reference's computation, so a
    1-wide window is bitwise the decode step — what the engine's greedy
    speculative-vs-plain parity rests on. Per-row exact: no row reads a
    position past its own window, so it needs no draft-length bound."""
    W = q.shape[1]
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    lengths = lengths.to(q.device).long()
    k = _gather_window(k_pool, page_table, k_scale)
    v = _gather_window(v_pool, page_table, v_scale)
    outs = []
    for r in range(W):
        lr = torch.where(lengths > 0, lengths + r, 0)
        outs.append(_reference_core(q[:, r].contiguous(), k, v, lr, sc))
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

def _check_int32(t, shape, what, name, dev):
    if t.device != dev or t.dtype != torch.int32 or \
            not t.is_contiguous() or (shape is not None and
                                      tuple(t.shape) != shape):
        want = "" if shape is None else f" {shape}"
        raise MXNetError(f"{what}: {name} must be contiguous int32{want} "
                         f"on {dev}")


def _check_operands(q, k_pool, v_pool, index, what, k_scale=None,
                    v_scale=None):
    """Validate a launch; returns the pool payload's dtype code (the q
    code for raw pools, ``_KV_CODE`` for quantized ones)."""
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(f"{what} kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise MXNetError(f"{what}: give both k_scale and v_scale, or "
                         f"neither")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev:
            raise MXNetError(f"{what}: {name} on {t.device}, q on {dev}")
        if quant and t.dtype not in _KV_CODE:
            raise MXNetError(f"{what}: {name} dtype {t.dtype} with scales "
                             f"must be int8 or float8_e4m3fn")
        if not quant and t.dtype != q.dtype:
            raise MXNetError(f"{what}: {name} dtype {t.dtype} != q dtype "
                             f"{q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be a contiguous "
                             f"(P, H, page_size, D) tensor")
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise MXNetError(f"{what}: k_pool {tuple(k_pool.shape)} "
                         f"{k_pool.dtype} != v_pool {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}")
    if quant:
        P = k_pool.shape[0]
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != dev or t.dtype != torch.float32 or \
                    t.shape != (P,) or not t.is_contiguous():
                raise MXNetError(f"{what}: {name} must be contiguous "
                                 f"float32 ({P},) on {dev}")
    _check_int32(index, None, what, "page table", dev)
    if not q.is_contiguous():
        raise MXNetError(f"{what}: q must be contiguous")
    _, H, _, D = k_pool.shape
    if q.shape[-2:] != (H, D):
        raise MXNetError(f"{what}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)}")
    if D > _MAX_HEAD_DIM:
        raise MXNetError(f"{what}: head dim {D} > {_MAX_HEAD_DIM}")
    return _KV_CODE[k_pool.dtype] if quant else _DTYPE_CODE[q.dtype]


def _raise_if_failed(lib, rc, what):
    if rc != 0:
        msg = lib.mx_cuda_error_string(rc).decode()
        raise MXNetError(f"{what} kernel launch failed: {msg} ({rc})")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [ctypes.c_float, _INT, _INT, _PTR]     # scale, dtype, kv_dtype,
_SIGNATURES = {                                # stream
    # library: {entry point: (argtypes, restype)}; every pointer and the
    # stream as c_void_p
    "ragged_decode": {
        "mx_ragged_decode": ([_PTR] * 9 + [_INT] * 7 + _TAIL, _INT)},
    "ragged_prefill": {
        "mx_ragged_prefill": ([_PTR] * 9 + [_INT] * 8 + _TAIL, _INT)},
    "ragged_verify": {
        "mx_ragged_verify": ([_PTR] * 10 + [_INT] * 8 + _TAIL, _INT)},
}


def _bind(name):
    """The kernel library ``name`` (built on first use) with argtypes and
    restype set on its entry points."""
    lib = _build.load(name)
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(name, quant):
    LAUNCHES[name + ("_q" if quant else "")] += 1


class PrefillPlan(NamedTuple):
    """How ``csrc/ragged_prefill.cu`` splits one chunk's keys."""
    tensor_cores: bool   # the mma.sync body (bf16 queries, D = 64)
    keys: int            # the page row's capacity, maxp * ps
    split_keys: int      # keys per split
    nsplit: int          # splits: ceil(keys / split_keys)
    q_tiles: int         # 64-row query tiles per block (tensor cores)
    blocks: int          # blocks launched
    scratch_floats: int  # f32 scratch of the merge kernel (0: none)


def prefill_plan(C, H, D, ps, maxp, tensor_cores, sms=H100_SMS):
    """The split plan of one chunked-prefill launch, from the chunk's
    shape and the page row's CAPACITY ``maxp * ps``: the chunk's span
    sits on the device, so where the chunk starts changes no launch
    argument (a chunk bucket's CUDA graph replays one launch at every
    depth), and blocks past the live keys walk nothing.

    Tensor-core body: a block owns one (head, key split) and a group of
    ``q_tiles`` 64-row query tiles (all of C when C <= 128, so each live
    K/V byte is read once). Splits are whole 64-key tiles, at most 16 (a
    head's splits form one thread-block cluster and merge in distributed
    shared memory: no scratch), as many as keep the heads x groups x
    nsplit blocks to about one wave of ``sms`` SMs at
    ``_PREFILL_BLOCKS_PER_SM`` each (``_wave_splits``, as verify and
    decode). CUDA-core body: 64-key splits of 16-row tiles, merged by a
    second launch from a scratch of (m, l, acc[D]) per row, head and
    split, laid out for all C rows."""
    keys = maxp * ps
    if not tensor_cores:
        nsplit = -(-keys // _CORE_SPLIT_KEYS)
        return PrefillPlan(False, keys, _CORE_SPLIT_KEYS, nsplit, 0,
                           -(-C // _CORE_ROWS) * H * nsplit,
                           C * H * nsplit * (D + 2))
    tiles = -(-C // _MMA_TILE)
    q_tiles = 1 if tiles <= 1 else 2
    groups = max(1, -(-tiles // q_tiles))
    split_keys, nsplit = _wave_splits(keys, H * groups,
                                      _PREFILL_BLOCKS_PER_SM, sms)
    return PrefillPlan(True, keys, split_keys, nsplit, q_tiles,
                       nsplit * H * groups, 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ragged_prefill_cuda(q, k_pool, v_pool, page_row, span, scale,
                         k_scale=None, v_scale=None):
    """Launch ``csrc/ragged_prefill.cu`` on the current stream, with the
    split plan of ``prefill_plan`` and exactly its scratch. ``span`` is
    the chunk's int32 (2,) ``[start, n_real]`` on q's device, read by the
    kernel alone (the caller keeps ``0 <= n_real <= C``); nothing here
    reads it, so the launch can be captured into a CUDA graph."""
    kv = _check_operands(q, k_pool, v_pool, page_row, "ragged prefill",
                         k_scale, v_scale)
    C, H, D = q.shape
    if page_row.dim() != 1:
        raise MXNetError(f"ragged prefill: page_row "
                         f"{tuple(page_row.shape)} is not (max_pages,)")
    _check_int32(span, (2,), "ragged prefill", "span", q.device)
    ps, maxp = k_pool.shape[2], page_row.shape[0]
    tc = q.dtype == torch.bfloat16 and D == _MMA_D
    if tc and any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise MXNetError("ragged prefill: q and the pools must be 16-byte "
                         "aligned (16-byte copies)")
    plan = prefill_plan(C, H, D, ps, maxp, tc, _sm_count(q.device))
    lib = _bind("ragged_prefill")
    out = torch.empty_like(q)
    part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                       device=q.device) if plan.scratch_floats else None
    rc = lib.mx_ragged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_row.data_ptr(), span.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        out.data_ptr(), _ptr(part), C, H, D, ps, maxp, plan.split_keys,
        plan.nsplit, plan.q_tiles, float(scale), _DTYPE_CODE[q.dtype], kv,
        _stream_ptr(q.device))
    _raise_if_failed(lib, rc, "ragged prefill")
    _count("ragged_prefill", k_scale is not None)
    return out


class VerifyPlan(NamedTuple):
    """How ``csrc/ragged_verify.cu`` splits a verify window's keys."""
    tensor_cores: bool   # the mma.sync body (bf16 queries, D = 64, W <= 64)
    keys: int            # the page row's capacity, maxp * ps
    split_keys: int      # keys per split
    nsplit: int          # splits: ceil(keys / split_keys)
    blocks: int          # blocks launched
    scratch_floats: int  # f32 scratch of the combine launch (0: none)


def verify_plan(S, W, H, D, ps, maxp, tensor_cores, sms=H100_SMS):
    """The split plan of one verify launch, from the page row's CAPACITY
    ``maxp * ps``: the live keys (``lengths + draft_len``) sit on the
    device, so no host value bounds them more tightly.

    Tensor-core body: splits are whole 64-key tiles, at most 16 (the
    splits of a (slot, head) form one thread-block cluster and merge in
    distributed shared memory: no scratch), as many as keep the S H
    nsplit blocks to about one wave of ``sms`` SMs at
    ``_VERIFY_BLOCKS_PER_SM`` resident blocks each (another wave costs
    more than a longer walk; a capacity above 16 tiles gives wider
    splits); a block owns one (split, head, slot). CUDA-core body: 64-key
    splits, merged by a second launch from a scratch of (m, l, acc[D])
    per (slot, row, head, split)."""
    keys = maxp * ps
    if not tensor_cores:
        nsplit = -(-keys // _CORE_SPLIT_KEYS)
        return VerifyPlan(False, keys, _CORE_SPLIT_KEYS, nsplit,
                          S * H * nsplit, S * W * H * nsplit * (D + 2))
    split_keys, nsplit = _wave_splits(keys, S * H, _VERIFY_BLOCKS_PER_SM,
                                      sms)
    return VerifyPlan(True, keys, split_keys, nsplit, S * H * nsplit, 0)


def _wave_splits(keys, heads, blocks_per_sm, sms):
    """(split_keys, nsplit): the capacity ``keys`` in whole 64-key tiles,
    at most 16 splits (one cluster), as many as keep ``heads`` x nsplit
    blocks to about one wave of ``sms`` SMs at ``blocks_per_sm`` each."""
    ktiles = -(-keys // _MMA_TILE)
    want = max(1, blocks_per_sm * sms // max(1, heads))
    split_keys = _MMA_TILE * -(-ktiles // min(ktiles, _MAX_CLUSTER, want))
    return split_keys, -(-keys // split_keys)


def _ragged_verify_cuda(q, k_pool, v_pool, page_table, lengths, draft_len,
                        scale, k_scale=None, v_scale=None):
    """Launch ``csrc/ragged_verify.cu`` on the current stream, with the
    split plan of ``verify_plan``. The body is chosen by shape before the
    launch: bf16 queries with D = 64 and W <= 64 (one 64-row tile) run on
    the tensor cores in one launch; anything else (f32 queries, another
    head dim, W > 64) on the CUDA cores, a split launch and a combine
    launch through exactly the plan's scratch."""
    kv = _check_operands(q, k_pool, v_pool, page_table, "ragged verify",
                         k_scale, v_scale)
    if q.dim() != 4:
        raise MXNetError(f"ragged verify: q {tuple(q.shape)} is not "
                         f"(S, W, H, D)")
    S, W, H, D = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != S:
        raise MXNetError(f"ragged verify: page_table "
                         f"{tuple(page_table.shape)} is not (S={S}, "
                         f"max_pages)")
    _check_int32(lengths, (S,), "ragged verify", "lengths", q.device)
    _check_int32(draft_len, (S,), "ragged verify", "draft_len", q.device)
    ps, maxp = k_pool.shape[2], page_table.shape[1]
    tc = q.dtype == torch.bfloat16 and D == _MMA_D and W <= _MMA_TILE
    if tc and any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise MXNetError("ragged verify: q and the pools must be 16-byte "
                         "aligned (16-byte copies)")
    plan = verify_plan(S, W, H, D, ps, maxp, tc, _sm_count(q.device))
    lib = _bind("ragged_verify")
    out = torch.empty_like(q)
    part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                       device=q.device) if plan.scratch_floats else None
    rc = lib.mx_ragged_verify(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), draft_len.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), out.data_ptr(), _ptr(part), S, W, H,
        D, ps, maxp, plan.split_keys, plan.nsplit, float(scale),
        _DTYPE_CODE[q.dtype], kv, _stream_ptr(q.device))
    _raise_if_failed(lib, rc, "ragged verify")
    _count("ragged_verify", k_scale is not None)
    return out


class DecodePlan(NamedTuple):
    """How ``csrc/ragged_decode.cu`` splits a decode step's keys."""
    tensor_cores: bool   # the mma.sync body (bf16 queries, D = 64)
    keys: int            # the page row's capacity, maxp * ps
    split_keys: int      # keys per split
    nsplit: int          # splits: ceil(keys / split_keys)
    blocks: int          # blocks launched (the first launch)
    scratch_floats: int  # f32 scratch of the combine launch (0: none)


def decode_plan(S, H, D, ps, maxp, tensor_cores, sms=H100_SMS):
    """The split plan of one decode launch, from the page row's CAPACITY
    ``maxp * ps``: the lengths sit on the device, and a plan fixed by the
    shapes alone leaves every step's launch the same.

    Tensor-core body: splits are whole 64-key tiles, at most 16 (the
    splits of a (slot, head) form one thread-block cluster and merge in
    distributed shared memory: no scratch), as many as keep the S H
    nsplit blocks to about one wave of ``sms`` SMs at
    ``_DECODE_BLOCKS_PER_SM`` resident blocks each; a block owns one
    (split, head, slot). CUDA-core body: 64-key splits, merged by a
    second launch from a scratch of (m, l, acc[D]) per (slot, head,
    split)."""
    keys = maxp * ps
    if not tensor_cores:
        nsplit = -(-keys // _CORE_SPLIT_KEYS)
        return DecodePlan(False, keys, _CORE_SPLIT_KEYS, nsplit,
                          S * H * nsplit, S * H * nsplit * (D + 2))
    split_keys, nsplit = _wave_splits(keys, S * H, _DECODE_BLOCKS_PER_SM,
                                      sms)
    return DecodePlan(True, keys, split_keys, nsplit, S * H * nsplit, 0)


def _ragged_decode_cuda(q, k_pool, v_pool, page_table, lengths, scale,
                        k_scale=None, v_scale=None):
    """Launch ``csrc/ragged_decode.cu`` on the current stream, with the
    split plan of ``decode_plan``. The body is chosen by shape before the
    launch: bf16 queries with D = 64 run on the tensor cores in one launch
    with no scratch; f32 queries and other head dims on the CUDA cores, a
    split launch and a combine launch through exactly the plan's
    scratch."""
    kv = _check_operands(q, k_pool, v_pool, page_table, "ragged decode",
                         k_scale, v_scale)
    if q.dim() != 3:
        raise MXNetError(f"ragged decode: q {tuple(q.shape)} is not "
                         f"(S, H, D)")
    S, H, D = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != S:
        raise MXNetError(f"ragged decode: page_table {tuple(page_table.shape)}"
                         f" is not (S={S}, max_pages)")
    _check_int32(lengths, (S,), "ragged decode", "lengths", q.device)
    ps, maxp = k_pool.shape[2], page_table.shape[1]
    tc = q.dtype == torch.bfloat16 and D == _MMA_D
    if tc and any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise MXNetError("ragged decode: q and the pools must be 16-byte "
                         "aligned (16-byte copies)")
    plan = decode_plan(S, H, D, ps, maxp, tc, _sm_count(q.device))
    lib = _bind("ragged_decode")
    out = torch.empty_like(q)
    part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                       device=q.device) if plan.scratch_floats else None
    rc = lib.mx_ragged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), out.data_ptr(), _ptr(part), S, H, D, ps, maxp,
        plan.split_keys, plan.nsplit, float(scale), _DTYPE_CODE[q.dtype], kv,
        _stream_ptr(q.device))
    _raise_if_failed(lib, rc, "ragged decode")
    _count("ragged_decode", k_scale is not None)
    return out


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def ragged_paged_attention(q, k_pool, v_pool, page_table, lengths,
                           scale=None, k_scale=None, v_scale=None):
    """Decode attention for one new token per slot against the paged
    pool. q: (S, H, D); k_pool/v_pool: (P, H, page_size, D); page_table:
    (S, max_pages) int32 (dead entries 0 = null page); lengths: (S,)
    int32 — live KV tokens INCLUDING the one just written;
    ``k_scale``/``v_scale`` (P,) f32 mark code pools. Returns (S, H, D)
    in q's dtype. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    sc = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.is_cuda:
        return _ragged_decode_cuda(q, k_pool, v_pool, page_table, lengths,
                                   sc, k_scale, v_scale)
    return ragged_attention_reference(q, k_pool, v_pool, page_table,
                                      lengths, sc, k_scale, v_scale)


def ragged_prefill_attention(q, k_pool, v_pool, page_row, q_start,
                             n_real=None, scale=None, k_scale=None,
                             v_scale=None):
    """Chunked-prefill attention for ONE slot: C chunk queries at
    absolute positions ``start + i`` attend the slot's paged prefix plus
    the causal intra-chunk part. q: (C, H, D); page_row: (max_pages,)
    int32. The chunk is either a span — ``q_start`` an int32 (2,) tensor
    ``[start, n_real]`` on q's device, read on the device only (what a
    CUDA graph replays; the caller keeps ``0 <= n_real <= C``) — or host
    ints ``q_start`` and ``n_real`` (live rows, default C), which are
    staged into a span, so the kernel has one signature. Returns (C, H,
    D); rows past ``n_real`` are exact zeros.

    PRECONDITION: the chunk's own K/V rows are already written into the
    slot's pages, and every page covering [0, start + n_real) is live."""
    sc = q.shape[-1] ** -0.5 if scale is None else float(scale)
    span = chunk_span(q_start, n_real, q.shape[0], q.device)
    if q.is_cuda:
        return _ragged_prefill_cuda(q, k_pool, v_pool, page_row, span, sc,
                                    k_scale, v_scale)
    return ragged_prefill_reference(q, k_pool, v_pool, page_row, span, sc,
                                    k_scale=k_scale, v_scale=v_scale)


def ragged_verify_attention(q, k_pool, v_pool, page_table, lengths,
                            draft_len=None, scale=None, k_scale=None,
                            v_scale=None):
    """Speculative-verify attention: W queries per slot, row r at
    position ``lengths[s] - 1 + r`` attending keys ``[0, lengths[s] - 1
    + r]`` (the paged prefix plus the causal part of the window). q:
    (S, W, H, D); lengths: (S,) int32 = keys visible to row 0 (0 = dead
    slot, exact zeros); ``draft_len`` (S,) int32 = each slot's real
    draft count (default W - 1), the index of its last consumed row.
    Returns (S, W, H, D).

    PRECONDITION: K/V of every position a consumed row reads, [0,
    lengths[s] + draft_len[s]), are written. The kernel selects V out
    from ``lengths + draft_len`` — positions past it are unwritten this
    step and a recycled page may hold NaN there — so rows past
    ``draft_len`` are garbage by contract."""
    sc = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if draft_len is None:
        draft_len = torch.full((q.shape[0],), q.shape[1] - 1,
                               dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return _ragged_verify_cuda(q, k_pool, v_pool, page_table, lengths,
                                   draft_len, sc, k_scale, v_scale)
    return ragged_verify_reference(q, k_pool, v_pool, page_table, lengths,
                                   sc, k_scale, v_scale)
