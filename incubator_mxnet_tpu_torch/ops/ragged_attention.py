"""Ragged paged-KV attention for serving: decode and chunked prefill.

K/V live in a shared page pool per layer,

    k_pool / v_pool : (num_pages, H, page_size, D)

and each slot owns an ordered page-table row. Page 0 is the NULL page:
never allocated, every dead page-table entry points at it, and every
read of it is masked by the slot's length.

Two functions, each with a hand-written CUDA kernel (``csrc/``) and a
plain PyTorch version in this module:

  - ``ragged_paged_attention`` (decode): one query per slot over that
    slot's live pages — ``csrc/ragged_decode.cu``, the port of the JAX
    package's ``_ragged_kernel``;
  - ``ragged_prefill_attention`` (chunked prefill): C queries of one
    slot at positions ``q_start + i`` over the paged prefix plus the
    causal part of the chunk — ``csrc/ragged_prefill.cu``, the port of
    ``_ragged_prefill_kernel``.

Dispatch is by device only: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor runs the plain version. There is no
fallback between the two. Both share the masked-row contract: masked
positions are selected out of V, the masked score is -1e30, a slot with
nothing to attend emits exactly zero, and a NaN propagates.

``LAUNCHES`` counts kernel launches per kernel; the wrappers add one
only where they launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

_NEG_INF = -1e30

__all__ = ["ragged_paged_attention", "ragged_attention_reference",
           "ragged_prefill_attention", "ragged_prefill_reference",
           "LAUNCHES", "reset_launch_counts"]

LAUNCHES = {"ragged_decode": 0, "ragged_prefill": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path, and the oracle the kernels are
# held against on the card)
# --------------------------------------------------------------------- #

def _gather_window(pool, page_table):
    """(S, H, K, D) dense window of each slot's pages, K = max_pages *
    page_size."""
    S, n_pages = page_table.shape
    _, H, ps, D = pool.shape
    g = pool[page_table.long()]                  # (S, n_pages, H, ps, D)
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
                               scale=None):
    """Plain decode attention: gather each slot's pages to a dense
    window, mask positions >= length, softmax in f32."""
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    k = _gather_window(k_pool, page_table)
    v = _gather_window(v_pool, page_table)
    return _reference_core(q, k, v, lengths, sc)


def ragged_prefill_reference(q, k_pool, v_pool, page_row, q_start,
                             scale=None, n_real=None):
    """Plain chunked-prefill attention for one slot: gather the slot's
    page window, apply the per-query mask ``pos_k <= q_start + i``,
    select V positions ``>= q_start + n_real`` out (no live row may read
    them; on a partial chunk they are unwritten and may hold a recycled
    page's NaN), softmax in f32. Rows ``>= n_real`` are padding: their
    output is garbage by contract."""
    C, H, D = q.shape
    ps = k_pool.shape[2]
    n_pages = page_row.shape[0]
    K = n_pages * ps
    sc = D ** -0.5 if scale is None else scale
    q_start = int(q_start)
    n_real = C if n_real is None else int(n_real)

    def window(pool):
        g = pool[page_row.long()]                # (n_pages, H, ps, D)
        return g.permute(1, 0, 2, 3).reshape(H, K, D)

    k = window(k_pool)
    v = window(v_pool)
    s = torch.einsum("chd,hkd->chk", q.float(), k.float()) * sc
    pos_k = torch.arange(K, device=q.device)[None, :]
    pos_q = q_start + torch.arange(C, device=q.device)[:, None]
    s = torch.where((pos_k <= pos_q)[:, None, :], s, _NEG_INF)
    never_read = torch.arange(K, device=q.device) >= q_start + n_real
    v = torch.where(never_read[None, :, None], 0.0, v.float())
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("chk,hkd->chd", p, v) / \
        torch.clamp(l, min=1e-30)[..., None]
    row_ok = ~(m <= _NEG_INF / 2)
    return torch.where(row_ok[..., None], out, 0.0).to(q.dtype)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

def _check_operands(q, k_pool, v_pool, index, what):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(f"{what} kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev:
            raise MXNetError(f"{what}: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise MXNetError(f"{what}: {name} dtype {t.dtype} != q dtype "
                             f"{q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be a contiguous "
                             f"(P, H, page_size, D) tensor")
    if k_pool.shape != v_pool.shape:
        raise MXNetError(f"{what}: k_pool {tuple(k_pool.shape)} != "
                         f"v_pool {tuple(v_pool.shape)}")
    if index.device != dev or index.dtype != torch.int32 or \
            not index.is_contiguous():
        raise MXNetError(f"{what}: page table must be contiguous int32 on "
                         f"{dev}")
    if not q.is_contiguous():
        raise MXNetError(f"{what}: q must be contiguous")
    _, H, _, D = k_pool.shape
    if q.shape[-2:] != (H, D):
        raise MXNetError(f"{what}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)}")
    if D > _MAX_HEAD_DIM:
        raise MXNetError(f"{what}: head dim {D} > {_MAX_HEAD_DIM}")


def _raise_if_failed(lib, rc, what):
    if rc != 0:
        msg = lib.mx_cuda_error_string(rc).decode()
        raise MXNetError(f"{what} kernel launch failed: {msg} ({rc})")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype); every pointer and the stream as c_void_p
    "mx_ragged_decode": ([_PTR] * 7 + [_INT] * 5 +
                         [ctypes.c_float, _INT, _PTR], _INT),
    "mx_ragged_decode_scratch": ([_INT] * 5, ctypes.c_longlong),
    "mx_ragged_prefill": ([_PTR] * 6 + [_INT] * 7 +
                          [ctypes.c_float, _INT, _PTR], _INT),
    "mx_ragged_prefill_scratch": ([_INT] * 5, ctypes.c_longlong),
}


def _bind(name):
    """The kernel library ``name`` (built on first use) with argtypes and
    restype set on its entry points."""
    lib = _build.load(name)
    for fn_name in (f"mx_{name}", f"mx_{name}_scratch"):
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = _SIGNATURES[fn_name]
    return lib


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ragged_decode_cuda(q, k_pool, v_pool, page_table, lengths, scale):
    """Launch ``csrc/ragged_decode.cu`` on the current stream."""
    _check_operands(q, k_pool, v_pool, page_table, "ragged decode")
    S, H, D = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != S:
        raise MXNetError(f"ragged decode: page_table {tuple(page_table.shape)}"
                         f" is not (S={S}, max_pages)")
    if lengths.shape != (S,) or lengths.dtype != torch.int32 or \
            lengths.device != q.device or not lengths.is_contiguous():
        raise MXNetError("ragged decode: lengths must be contiguous (S,) "
                         "int32 on the device of q")
    ps, maxp = k_pool.shape[2], page_table.shape[1]
    lib = _bind("ragged_decode")
    out = torch.empty_like(q)
    part = torch.empty(lib.mx_ragged_decode_scratch(S, H, D, ps, maxp),
                       dtype=torch.float32, device=q.device)
    rc = lib.mx_ragged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part.data_ptr(), S, H, D, ps, maxp, float(scale),
        _DTYPE_CODE[q.dtype], _stream_ptr(q.device))
    _raise_if_failed(lib, rc, "ragged decode")
    LAUNCHES["ragged_decode"] += 1
    return out


def _ragged_prefill_cuda(q, k_pool, v_pool, page_row, q_start, n_real,
                         scale):
    """Launch ``csrc/ragged_prefill.cu`` on the current stream."""
    _check_operands(q, k_pool, v_pool, page_row, "ragged prefill")
    C, H, D = q.shape
    if page_row.dim() != 1:
        raise MXNetError(f"ragged prefill: page_row "
                         f"{tuple(page_row.shape)} is not (max_pages,)")
    if not (0 <= n_real <= C) or q_start < 0:
        raise MXNetError(f"ragged prefill: n_real {n_real} outside "
                         f"[0, {C}] or q_start {q_start} < 0")
    ps, maxp = k_pool.shape[2], page_row.shape[0]
    lib = _bind("ragged_prefill")
    out = torch.empty_like(q)
    part = torch.empty(lib.mx_ragged_prefill_scratch(C, H, D, ps, maxp),
                       dtype=torch.float32, device=q.device)
    rc = lib.mx_ragged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_row.data_ptr(), out.data_ptr(), part.data_ptr(), int(q_start),
        int(n_real), C, H, D, ps, maxp, float(scale),
        _DTYPE_CODE[q.dtype], _stream_ptr(q.device))
    _raise_if_failed(lib, rc, "ragged prefill")
    LAUNCHES["ragged_prefill"] += 1
    return out


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def ragged_paged_attention(q, k_pool, v_pool, page_table, lengths,
                           scale=None):
    """Decode attention for one new token per slot against the paged
    pool. q: (S, H, D); k_pool/v_pool: (P, H, page_size, D); page_table:
    (S, max_pages) int32 (dead entries 0 = null page); lengths: (S,)
    int32 — live KV tokens INCLUDING the one just written. Returns
    (S, H, D). CUDA tensors run the kernel, CPU tensors the plain
    version."""
    sc = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.is_cuda:
        return _ragged_decode_cuda(q, k_pool, v_pool, page_table, lengths,
                                   sc)
    return ragged_attention_reference(q, k_pool, v_pool, page_table,
                                      lengths, sc)


def ragged_prefill_attention(q, k_pool, v_pool, page_row, q_start,
                             n_real=None, scale=None):
    """Chunked-prefill attention for ONE slot: C chunk queries at
    absolute positions ``q_start + i`` attend the slot's paged prefix
    plus the causal intra-chunk part. q: (C, H, D); page_row:
    (max_pages,) int32; ``q_start`` and ``n_real`` (live rows, default
    C) are host ints. Returns (C, H, D); rows past ``n_real`` are
    garbage by contract.

    PRECONDITION: the chunk's own K/V rows are already written into the
    slot's pages, and every page covering [0, q_start + n_real) is
    live."""
    sc = q.shape[-1] ** -0.5 if scale is None else float(scale)
    n = q.shape[0] if n_real is None else int(n_real)
    if q.is_cuda:
        return _ragged_prefill_cuda(q, k_pool, v_pool, page_row,
                                    int(q_start), n, sc)
    return ragged_prefill_reference(q, k_pool, v_pool, page_row, q_start,
                                    sc, n_real=n)
