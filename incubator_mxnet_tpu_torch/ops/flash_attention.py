"""Flash attention, forward and backward: the port of the JAX package's
``incubator_mxnet_tpu/ops/pallas_attention.py`` (named for what it
computes: the port has no Pallas).

(B, H, T, D) attention with a per-batch key-length prefix mask
``valid_len`` (capped at Tk) and optional causal masking (top-left, square
Tq == Tk only), in three forms:

  - plain PyTorch versions: ``dense_attn_lse`` (the port of
    ``_dense_attn_lse``) returns ``(out, lse)``, and ``dense_attn_bwd``,
    an analytic backward from the saved ``lse`` (the formula of
    ``_dense_block_bwd``): p = where(mask, exp(s - lse), 0),
    Δ = rowsum(dO ⊙ O), ds = p (dp - Δ) scale;
  - three hand-written CUDA kernels: ``csrc/flash_fwd.cu`` (replaces the
    streaming ``_flash_kernel`` and the single-tile ``_dense_fwd_kernel``)
    and ``csrc/flash_bwd.cu``, whose ``dq`` and ``dkv`` entry points
    replace ``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel`` and the
    fused ``_dense_bwd_kernel``;
  - ``flash_attention_bhtd``, a ``torch.autograd.Function`` over them: a
    CUDA tensor runs the kernels (or the wrapper raises), a CPU tensor the
    plain versions. Δ is computed in plain torch, as the JAX package does
    in XLA.

``use_flash_attention`` is the static dispatch of ``ops.attention``'s
flash path: length-form masks on a shape the kernels take go to
``flash_attention_bhtd``; a boolean-only mask, or a shape they do not take
(``cuda_kernel_eligible``), goes to ``_sdpa_blockwise``, the streaming
softmax in plain torch (the port of the JAX package's
``ops/attention.py`` ``_sdpa_blockwise``). It never falls back because a
kernel failed.

The contract: a fully masked row gives zero output, lse = -1e30 and
finite gradients. ``LAUNCHES`` counts kernel launches; the wrappers add
one only where they launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["dense_attn_lse", "dense_attn_bwd", "flash_attention_bhtd",
           "use_flash_attention", "cuda_kernel_eligible", "attn_delta",
           "valid_length_mask", "LAUNCHES", "reset_launch_counts"]

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path, and the oracle the kernels are
# held against on the card)
# --------------------------------------------------------------------- #

def valid_length_mask(valid_len, Tk, device):
    """(B, Tk) boolean key mask: key j of batch b is live when
    j < valid_len[b]."""
    return torch.arange(Tk, device=device)[None, :] < \
        valid_len.to(device).long()[:, None]


def _prefix_causal_mask(Tq, Tk, valid_len, causal, device):
    """(B, 1, Tq, Tk) boolean mask: keys < valid_len, optionally causal
    (bottom-right aligned for Tq != Tk, which is top-left when square)."""
    mask = valid_length_mask(valid_len, Tk, device)[:, None, None, :]
    if causal:
        q_pos = torch.arange(Tq, device=device)[:, None]
        k_pos = torch.arange(Tk, device=device)[None, :]
        mask = mask & (k_pos <= q_pos + (Tk - Tq))[None, None]
    return mask


def _scale(D, scale):
    return D ** -0.5 if scale is None else float(scale)


def dense_attn_lse(q, k, v, valid_len, causal=False, scale=None):
    """Plain forward: (out, lse). q/k/v (B, H, T, D); the scores, softmax
    and value product in f32 (wider than f32 inputs stay as they are);
    out in q's dtype, lse (B, H, Tq) f32 (the computation type)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    sc = _scale(D, scale)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * sc
    mask = _prefix_causal_mask(Tq, Tk, valid_len, causal, q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(ct)) / \
        torch.clamp(l, min=1e-30)[..., None]
    # fully masked rows (and NaN rows, as in the reference) are zero with
    # lse = -1e30
    row_ok = m > _NEG_INF / 2
    out = torch.where(row_ok[..., None], out, 0.0)
    lse = torch.where(row_ok, m + torch.log(torch.clamp(l, min=1e-30)),
                      _NEG_INF)
    return out.to(q.dtype), lse


def attn_delta(out, dout):
    """Δ = rowsum(dO ⊙ O) in f32 (or wider): (B, H, Tq)."""
    ct = torch.promote_types(out.dtype, torch.float32)
    return (dout.to(ct) * out.to(ct)).sum(dim=-1)


def dense_attn_bwd(q, k, v, valid_len, out, lse, dout, causal=False,
                   scale=None):
    """Plain analytic backward from the saved lse (no forward recompute):
    (dq, dk, dv) in the inputs' dtypes. p is rebuilt under a select on
    the mask, so a fully masked row (lse = -1e30, exp(s - lse) = inf)
    contributes exact zeros."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    sc = _scale(D, scale)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (x.to(ct) for x in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sc
    mask = _prefix_causal_mask(Tq, Tk, valid_len, causal, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(ct)[..., None]), 0.0)
    delta = attn_delta(out, dout).to(ct)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * sc
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _sdpa_blockwise(q, k, v, key_mask, causal, scale, block_k: int = 512):
    """Streaming softmax over key blocks (the flash recurrence) in plain
    torch. q: (B, Tq, H, D); k/v: (B, Tk, H, D); key_mask: (B, Tk) bool or
    None; causal is bottom-right aligned for Tq != Tk. Scores and the
    running statistics in f32 (the products of the operands are exact
    there), the scale on the f32 scores, p cast to v's dtype before the
    value product; a fully masked row is zero."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    block_k = max(1, min(block_k, Tk))
    if key_mask is None:
        key_mask = torch.ones((B, Tk), dtype=torch.bool, device=q.device)
    key_mask = key_mask.bool()
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct)
    pos_q = torch.arange(Tq, device=q.device)
    acc = torch.zeros((B, Tq, H, D), dtype=ct, device=q.device)
    row_max = torch.full((B, Tq, H), _NEG_INF, dtype=ct, device=q.device)
    row_sum = torch.zeros((B, Tq, H), dtype=ct, device=q.device)
    for k0 in range(0, Tk, block_k):
        k_blk = k[:, k0:k0 + block_k]
        v_blk = v[:, k0:k0 + block_k]
        n = k_blk.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.to(ct)) * scale
        allow = key_mask[:, k0:k0 + n][:, None, None, :]
        if causal:
            pos_k = k0 + torch.arange(n, device=q.device)
            allow = allow & (pos_k[None, :] <=
                             pos_q[:, None] + (Tk - Tq))[None, None]
        s = torch.where(allow, s, _NEG_INF)
        blk_max = s.amax(dim=-1).permute(0, 2, 1)            # (B, Tq, H)
        new_max = torch.maximum(row_max, blk_max)
        corr = torch.exp(row_max - new_max)
        p = torch.exp(s - new_max.permute(0, 2, 1)[..., None])
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(v.dtype).to(ct), v_blk.to(ct))
        row_sum = row_sum * corr + p.sum(dim=-1).permute(0, 2, 1)
        row_max = new_max
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]
    out = torch.where((row_max > _NEG_INF / 2)[..., None], out, 0.0)
    return out.to(q.dtype)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_INT] * 5 + [_FLOAT, _INT, _INT, _PTR]  # B H Tq Tk D scale causal
_SIGNATURES = {                                    # dtype stream
    "mx_flash_fwd": [_PTR] * 6 + _TAIL,
    "mx_flash_bwd_dq": [_PTR] * 8 + _TAIL,
    "mx_flash_bwd_dkv": [_PTR] * 9 + _TAIL,
}


def _bind(lib_name, fn_name):
    """The entry point ``fn_name`` of kernel library ``lib_name`` (built
    on first use), with its argtypes set."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = _SIGNATURES[fn_name], _INT
    return lib, fn


def _check(what, q, k, v, valid_len, causal, extra=()):
    """Validate a launch; returns (B, H, Tq, Tk, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(f"{what} kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"{what}: q/k/v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise MXNetError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if D > _MAX_HEAD_DIM or D % 8:
        raise MXNetError(f"{what}: head dim {D} must be a multiple of 8 "
                         f"and <= {_MAX_HEAD_DIM}")
    if causal and Tq != Tk:
        raise MXNetError(f"{what}: causal needs Tq == Tk, got {Tq}, {Tk}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != dev or not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be contiguous on {dev}")
        if name in ("k", "v", "dout") and t.dtype != q.dtype:
            raise MXNetError(f"{what}: {name} dtype {t.dtype} != q dtype "
                             f"{q.dtype}")
        if name == "dout" and t.shape != q.shape:
            raise MXNetError(f"{what}: dout must be {tuple(q.shape)}")
        if name in ("lse", "delta") and (t.dtype != torch.float32 or
                                         t.shape != (B, H, Tq)):
            raise MXNetError(f"{what}: {name} must be float32 "
                             f"{(B, H, Tq)}")
    if valid_len.device != dev or valid_len.dtype != torch.int32 or \
            valid_len.shape != (B,) or not valid_len.is_contiguous():
        raise MXNetError(f"{what}: valid_len must be contiguous int32 "
                         f"({B},) on {dev}")
    return B, H, Tq, Tk, D


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_if_failed(lib, rc, what):
    if rc != 0:
        msg = lib.mx_cuda_error_string(rc).decode()
        raise MXNetError(f"{what} kernel launch failed: {msg} ({rc})")


def _flash_fwd_cuda(q, k, v, valid_len, causal, scale):
    """Launch ``csrc/flash_fwd.cu``: (out, lse)."""
    B, H, Tq, Tk, D = _check("flash forward", q, k, v, valid_len, causal)
    lib, fn = _bind("flash_fwd", "mx_flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
            _scale(D, scale), int(causal), _DTYPE_CODE[q.dtype],
            _stream(q.device))
    _raise_if_failed(lib, rc, "flash forward")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, valid_len, dout, lse, delta, causal,
                       scale):
    """Launch the dq entry point of ``csrc/flash_bwd.cu``."""
    B, H, Tq, Tk, D = _check("flash dq", q, k, v, valid_len, causal,
                             (("dout", dout), ("lse", lse),
                              ("delta", delta)))
    lib, fn = _bind("flash_bwd", "mx_flash_bwd_dq")
    dq = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), valid_len.data_ptr(),
            dq.data_ptr(), B, H, Tq, Tk, D, _scale(D, scale), int(causal),
            _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_if_failed(lib, rc, "flash dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, valid_len, dout, lse, delta, causal,
                        scale):
    """Launch the dk/dv entry point of ``csrc/flash_bwd.cu``."""
    B, H, Tq, Tk, D = _check("flash dkv", q, k, v, valid_len, causal,
                             (("dout", dout), ("lse", lse),
                              ("delta", delta)))
    lib, fn = _bind("flash_bwd", "mx_flash_bwd_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), valid_len.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, D, _scale(D, scale),
            int(causal), _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_if_failed(lib, rc, "flash dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# --------------------------------------------------------------------- #
# autograd entry
# --------------------------------------------------------------------- #

class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, valid_len, out, lse); backward computes Δ
    in plain torch and runs the dq and dk/dv kernels (CUDA) or the plain
    analytic backward (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, causal, scale):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, valid_len, causal, scale)
        else:
            out, lse = dense_attn_lse(q, k, v, valid_len, causal, scale)
        ctx.save_for_backward(q, k, v, valid_len, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid_len, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if q.is_cuda:
            delta = attn_delta(out, dout)
            dq = _flash_bwd_dq_cuda(q, k, v, valid_len, dout, lse, delta,
                                    ctx.causal, ctx.scale)
            dk, dv = _flash_bwd_dkv_cuda(q, k, v, valid_len, dout, lse,
                                         delta, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = dense_attn_bwd(q, k, v, valid_len, out, lse, dout,
                                        ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_bhtd(q, k, v, valid_len, causal=False, scale=None):
    """Flash attention in (B, H, T, D) layout with its backward.
    ``valid_len`` (B,) int key lengths (capped at Tk). CUDA tensors run
    the kernels, CPU tensors the plain versions. Returns (B, H, Tq, D)."""
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        valid_len = valid_len.to(device=q.device,
                                 dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, valid_len, bool(causal), scale)


def cuda_kernel_eligible(D, causal=False, Tq=None, Tk=None):
    """True when the CUDA kernels take this shape: D <= 256 and a
    multiple of 8, and not causal with Tq != Tk (offset causal queries
    take the blockwise path, which is bottom-right aligned). The check is
    on the shape only: ``flash_attention_bhtd`` picks kernel or plain
    version by the tensors' device."""
    if causal and Tq is not None and Tq != Tk:
        return False
    return D <= _MAX_HEAD_DIM and D % 8 == 0


def use_flash_attention(q, k, v, key_mask=None, causal=False, scale=None,
                        valid_length=None, layout="bthd"):
    """Dispatch of the flash path: (B, T, H, D) in/out by default,
    ``layout="bhtd"`` takes and returns (B, H, T, D). Masks in length form
    (``valid_length``, or none) on a shape the kernels take run
    ``flash_attention_bhtd``; a boolean-only mask or another shape runs
    the blockwise plain path. When both ``key_mask`` and ``valid_length``
    are given they must describe the same prefix: the kernel reads the
    lengths, the fallback ANDs both (as in the JAX package)."""
    if layout == "bhtd":
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
    else:
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
    if valid_length is None and key_mask is None:
        valid_length = torch.full((B,), Tk, dtype=torch.int32,
                                  device=q.device)
    if not (cuda_kernel_eligible(D, causal, Tq, Tk)
            and valid_length is not None):
        sc = _scale(D, scale)
        if valid_length is not None:
            vlm = valid_length_mask(valid_length, Tk, q.device)
            key_mask = vlm if key_mask is None else (key_mask.bool() & vlm)
        if layout == "bhtd":
            out = _sdpa_blockwise(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), key_mask, causal, sc)
            return out.transpose(1, 2)
        return _sdpa_blockwise(q, k, v, key_mask, causal, sc)
    if layout == "bhtd":
        return flash_attention_bhtd(q, k, v, valid_length, causal, scale)
    out = flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), valid_length, causal,
                               scale)
    return out.transpose(1, 2)
