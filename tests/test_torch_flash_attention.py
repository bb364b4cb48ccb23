"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's ``ops/pallas_attention.py`` on the same numpy inputs.

The port's plain forward (``dense_attn_lse``) and analytic backward
(``dense_attn_bwd``) are held against JAX's ``_dense_attn_lse`` and
``jax.vjp`` of it, and against the Pallas kernels run in interpret mode,
both arms: the single-tile (dense) kernels and the streaming FA-2 ones
(``MXTPU_FLASH_DENSE_T`` set to 0). The autograd entry is checked with
``torch.autograd.gradcheck`` in f64, and the dispatch (boolean mask ->
blockwise; CPU tensors -> plain versions, no launch). The CUDA kernels
against the plain versions run only on a card (``cuda`` marker).

Tolerances (f32): 2e-5 on out and lse, 1e-4 on gradients — the two
frameworks sum the products in different orders; bf16 operands against
an f32 reference: 1e-2 (the output's rounding to bf16). The bf16 kernels
on the card: 1e-2 on out and lse, and each gradient within 2e-2 of the
largest |gradient| of its own (batch, head) slice (at least 1e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_tpu.ops import pallas_attention as jpa

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import attention as tatt
from incubator_mxnet_tpu_torch.ops import flash_attention as fa

ATOL_FWD, ATOL_GRAD, ATOL_BF16 = 2e-5, 1e-4, 1e-2


def _inputs(seed, B, H, Tq, Tk, D, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k = rng.randn(B, H, Tk, D).astype(np.float32)
    v = rng.randn(B, H, Tk, D).astype(np.float32)
    g = rng.randn(B, H, Tq, D).astype(np.float32)
    return q, k, v, g, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close_lse(got, want, atol=ATOL_FWD):
    """lse agrees on live rows; dead rows are exactly -1e30 in both."""
    got, want = np.asarray(got), np.asarray(want)
    dead = want <= -1e29
    np.testing.assert_array_equal(got[dead], np.float32(-1e30))
    np.testing.assert_allclose(got[~dead], want[~dead], atol=atol, rtol=0)


# lengths cover 0, 1, partial and full for every shape
SHAPES = [(16, 16, (0, 1, 9, 16)), (8, 24, (24, 5, 0, 1)),
          (24, 8, (8, 3, 1, 0))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk,lens", SHAPES)
def test_plain_forward_and_backward_match_jax_dense(causal, Tq, Tk, lens):
    q, k, v, g, vl = _inputs(0, 4, 2, Tq, Tk, 8, lens)
    jo, jl = jpa._dense_attn_lse(*_j(q, k, v, vl), causal, None)
    to, tl = fa.dense_attn_lse(*_t(q, k, v, vl), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL_FWD,
                               rtol=0)
    _close_lse(tl.numpy(), jl)
    # analytic backward against autodiff of the JAX oracle
    _, vjp = jax.vjp(lambda a, b, c: jpa._dense_attn_lse(
        a, b, c, jnp.asarray(vl), causal, None)[0], *_j(q, k, v))
    want = vjp(jnp.asarray(g))
    got = fa.dense_attn_bwd(*_t(q, k, v, vl), to, tl, torch.from_numpy(g),
                            causal)
    for name, a, b in zip("qkv", got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL_GRAD, rtol=0, err_msg=name)


@pytest.mark.parametrize("arm", ["dense", "streaming"])
@pytest.mark.parametrize("causal,Tq,Tk,lens", [
    (False, 24, 24, (24, 13, 0)), (True, 24, 24, (24, 13, 1)),
    (False, 16, 40, (40, 17, 0))])
def test_plain_matches_pallas_kernels_interpret(arm, causal, Tq, Tk, lens):
    """The Pallas forward and backward kernels, interpret mode, each arm
    called directly (the streaming arm with 8-row / 8-key tiles)."""
    q, k, v, g, vl = _inputs(1, 3, 2, Tq, Tk, 8, lens)
    dense = arm == "dense"
    blocks = {} if dense else {"block_q": 8, "block_k": 8}
    hpp = jpa._dense_hpp(2) if dense else None
    jo, jl = jpa._flash_fwd_lse(*_j(q, k, v, vl), causal=causal,
                                interpret=True, dense=dense, hpp=hpp,
                                **blocks)
    to, tl = fa.dense_attn_lse(*_t(q, k, v, vl), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL_FWD,
                               rtol=0)
    _close_lse(tl.numpy(), jl)
    hpp_b = jpa._dense_hpp(2, bwd=True) if dense else None
    want = jpa._flash_backward(*_j(q, k, v, vl), jo, jl, jnp.asarray(g),
                               causal=causal, interpret=True, dense=dense,
                               hpp=hpp_b, **blocks)
    got = fa.dense_attn_bwd(*_t(q, k, v, vl), to, tl, torch.from_numpy(g),
                            causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL_GRAD, rtol=0, err_msg=name)


@pytest.mark.parametrize("arm", ["dense", "streaming"])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_entry_matches_jax_custom_vjp(arm, causal, monkeypatch):
    """``flash_attention_bhtd`` (autograd.Function, CPU: plain versions)
    against the JAX custom_vjp over the Pallas kernels in interpret mode;
    the arm is chosen as the JAX package chooses it, by
    ``MXTPU_FLASH_DENSE_T``."""
    monkeypatch.setenv("MXTPU_FLASH_DENSE_T",
                       "4096" if arm == "dense" else "0")
    q, k, v, g, vl = _inputs(2, 2, 2, 24, 24, 8, (24, 11))

    def jloss(a, b, c):
        out = jpa.flash_attention_bhtd(a, b, c, jnp.asarray(vl), causal,
                                       None, True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    to = fa.flash_attention_bhtd(tq, tk, tv, torch.from_numpy(vl), causal)
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL_FWD, rtol=0)
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=ATOL_GRAD, rtol=0, err_msg=name)


def test_blockwise_matches_jax_blockwise():
    """The plain path of boolean masks, several key blocks, causal
    bottom-right with Tq != Tk."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 5, 3, 8).astype(np.float32)
    k = rng.randn(2, 13, 3, 8).astype(np.float32)
    v = rng.randn(2, 13, 3, 8).astype(np.float32)
    mask = rng.rand(2, 13) > 0.3
    mask[1] = False                                  # a fully masked batch
    for causal in (False, True):
        want = jatt._sdpa_blockwise(*_j(q, k, v, mask), causal, 0.3,
                                    block_k=4)
        got = fa._sdpa_blockwise(*_t(q, k, v, mask), causal, 0.3,
                                 block_k=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_FWD, rtol=0)
        assert (got[1] == 0).all()


def test_bf16_operands_match_f32_reference():
    q, k, v, g, vl = _inputs(4, 2, 2, 16, 16, 8, (16, 7))
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    # the reference sees the same bf16-rounded values, in f32
    rq, rk, rv = (x.float().numpy() for x in (qb, kb, vb))
    jo, jl = jpa._dense_attn_lse(*_j(rq, rk, rv, vl), False, None)
    to, tl = fa.dense_attn_lse(qb, kb, vb, torch.from_numpy(vl))
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo),
                               atol=ATOL_BF16, rtol=0)
    _close_lse(tl.numpy(), jl, atol=1e-4)
    grads = fa.dense_attn_bwd(qb, kb, vb, torch.from_numpy(vl), to, tl,
                              torch.from_numpy(g).bfloat16())
    _, vjp = jax.vjp(lambda a, b, c: jpa._dense_attn_lse(
        a, b, c, jnp.asarray(vl), False, None)[0], *_j(rq, rk, rv))
    for name, a, b in zip("qkv", grads, vjp(jnp.asarray(g))):
        assert a.dtype == torch.bfloat16, name
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=2e-2 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_rows_zero_output_and_finite_grads(causal):
    q, k, v, g, vl = _inputs(5, 2, 2, 12, 12, 8, (0, 12))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = fa.flash_attention_bhtd(tq, tk, tv, torch.from_numpy(vl), causal)
    _, lse = fa.dense_attn_lse(*_t(q, k, v, vl), causal)
    assert (out[0] == 0).all() and (lse[0] == -1e30).all()
    (out * torch.from_numpy(g)).sum().backward()
    for name, t in (("q", tq), ("k", tk), ("v", tv)):
        assert torch.isfinite(t.grad).all(), name
        assert (t.grad[0] == 0).all(), name


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_f64(causal):
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 5, 4)).requires_grad_()
               for _ in range(3))
    vl = torch.tensor([5, 3], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention_bhtd(a, b, c, vl, causal),
        (q, k, v), eps=1e-6, atol=1e-5)


def test_dispatch(monkeypatch):
    """Boolean-only masks and shapes the kernels do not take go to the
    blockwise path; length masks go to the autograd entry, which runs the
    plain versions on CPU tensors and launches nothing."""
    calls = []
    real_flash, real_block = fa.flash_attention_bhtd, fa._sdpa_blockwise
    monkeypatch.setattr(fa, "flash_attention_bhtd", lambda *a, **kw: (
        calls.append("flash"), real_flash(*a, **kw))[1])
    monkeypatch.setattr(fa, "_sdpa_blockwise", lambda *a, **kw: (
        calls.append("blockwise"), real_block(*a, **kw))[1])
    rng = np.random.RandomState(7)
    q, k, v = _t(*(rng.randn(2, 6, 2, 8).astype(np.float32)
                   for _ in range(3)))
    vl = torch.tensor([6, 4], dtype=torch.int32)
    bool_mask = torch.arange(6)[None, :] < vl[:, None].long()
    fa.reset_launch_counts()
    a = tatt.scaled_dot_product_attention(q, k, v, mask=bool_mask,
                                          flash=True)
    b = tatt.scaled_dot_product_attention(q, k, v, flash=True,
                                          valid_length=vl)
    c = tatt.scaled_dot_product_attention(q, k, v, mask=bool_mask,
                                          flash=True, valid_length=vl)
    assert calls == ["blockwise", "flash", "flash"]
    assert all(n == 0 for n in fa.LAUNCHES.values())
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL_FWD)
    np.testing.assert_allclose(b.numpy(), c.numpy(), atol=0)
    calls.clear()
    q12 = torch.randn(2, 6, 2, 12)
    tatt.scaled_dot_product_attention(q12, q12, q12, flash=True,
                                      valid_length=vl)
    tatt.scaled_dot_product_attention(q[:, :4], k, v, flash=True,
                                      causal=True, valid_length=vl)
    assert calls == ["blockwise", "blockwise"]
    assert fa.cuda_kernel_eligible(64) and fa.cuda_kernel_eligible(256)
    assert not fa.cuda_kernel_eligible(264)
    assert not fa.cuda_kernel_eligible(12)
    assert not fa.cuda_kernel_eligible(64, causal=True, Tq=8, Tk=16)
    assert fa.cuda_kernel_eligible(64, causal=True, Tq=16, Tk=16)
    with pytest.raises(MXNetError, match="CUDA device"):
        fa._flash_fwd_cuda(q, k, v, vl, False, None)
    with pytest.raises(MXNetError, match="layout"):
        tatt.scaled_dot_product_attention(q, k, v, layout="tbhd")
    with pytest.raises(MXNetError, match="bhtd"):
        tatt.scaled_dot_product_attention(q, k, v, layout="bhtd")


def test_dense_path_honors_valid_length_like_jax():
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 5, 2, 8).astype(np.float32) for _ in range(3))
    vl = np.asarray([5, 2], np.int32)
    want = jatt.scaled_dot_product_attention(*_j(q, k, v), causal=True,
                                             valid_length=jnp.asarray(vl))
    got = tatt.scaled_dot_product_attention(*_t(q, k, v), causal=True,
                                            valid_length=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_FWD, rtol=0)


# --------------------------------------------------------------------- #
# the CUDA kernels against the plain versions (on a card only)
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the flash kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Tq,Tk,D,lens,causal", [
    (4, 2, 128, 128, 64, (0, 1, 77, 128), False),
    (2, 2, 200, 200, 64, (200, 150), True),
    (2, 2, 96, 160, 128, (160, 33), False),
    (1, 2, 70, 70, 256, (70,), True)])
def test_kernels_match_plain_on_card(cuda_device, dtype, B, H, Tq, Tk, D,
                                     lens, causal):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    q, do = (torch.randn(B, H, Tq, D, generator=gen, device=cuda_device)
             .to(dt) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=gen, device=cuda_device)
            .to(dt) for _ in range(2))
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    fa.reset_launch_counts()
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    delta = fa.attn_delta(out, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, vl, do, lse, delta, causal, None)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, vl, do, lse, delta, causal,
                                    None)
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    ro, rl = fa.dense_attn_lse(q, k, v, vl, causal)
    grads = fa.dense_attn_bwd(q, k, v, vl, ro, rl, do, causal)
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ro.float(), atol=tol, rtol=tol)
    live = rl > -1e29
    torch.testing.assert_close(lse[live], rl[live], atol=tol, rtol=0)
    assert (lse[~live] == -1e30).all()
    for a, b in zip((dq, dk, dv), grads):
        if dtype == "float32":
            gtol = 1e-4
        else:        # 2e-2 of the largest |gradient| of each (b, h) slice
            gtol = 2e-2 * b.float().abs().amax(dim=(2, 3), keepdim=True) \
                .clamp(min=1e-2)
        assert ((a.float() - b.float()).abs() <= gtol).all()
