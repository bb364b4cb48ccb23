"""Ragged paged attention of the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
plain references and its Pallas kernels in interpret mode, and through
the port's plain PyTorch versions (the CPU path of
``incubator_mxnet_tpu_torch.ops.ragged_attention``): decode, chunked
prefill and the speculative verify window, over raw pools and over int8
/ float8_e4m3 code pools with per-page scales. The contract cases mirror
tests/test_ragged_attention.py: null-page leak, partial tail page, NaN
past the length, NaN inside the length, length 0, page-table
permutation, the partial-chunk and verify-window unwritten tails, and a
NaN page scale on a masked and on a live page. f32 tolerance: atol
1e-5, rtol 1e-5 (the two sides accumulate in f32 in different orders).

The CUDA kernels themselves run only on a card: the ``cuda`` tests hold
them against the plain versions and skip here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import ragged_attention as J
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.ops import ragged_attention as T

ATOL = RTOL = 1e-5


def _make_case(rng, S, H, D, ps, max_pages, lengths, num_pages=None):
    """Random pools + a SHUFFLED page table for the given lengths."""
    lengths = np.asarray(lengths, np.int32)
    n_live = [-(-int(l) // ps) for l in lengths]
    if num_pages is None:
        num_pages = 1 + sum(n_live)
    q = rng.randn(S, H, D).astype(np.float32)
    kp = rng.randn(num_pages, H, ps, D).astype(np.float32)
    vp = rng.randn(num_pages, H, ps, D).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))      # page 0 = null
    pt = np.zeros((S, max_pages), np.int32)
    used = 0
    for s in range(S):
        pt[s, :n_live[s]] = perm[used:used + n_live[s]]
        used += n_live[s]
    return q, kp, vp, pt, lengths


def _port_decode(q, kp, vp, pt, ln):
    return T.ragged_attention_reference(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(pt), torch.tensor(ln)).numpy()


def _jax_decode(q, kp, vp, pt, ln, kernel):
    args = [jnp.asarray(a) for a in (q, kp, vp, pt, ln)]
    if kernel:
        return np.asarray(J._ragged_pallas(*args, q.shape[-1] ** -0.5,
                                           True))
    return np.asarray(J.ragged_attention_reference(*args))


def _port_prefill(q, kp, vp, row, start, n_real):
    return T.ragged_prefill_reference(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(row), start, n_real=n_real).numpy()


def _jax_prefill(q, kp, vp, row, start, n_real, kernel):
    args = [jnp.asarray(a) for a in (q, kp, vp, row)]
    if kernel:
        return np.asarray(J._ragged_prefill_pallas(
            *args, jnp.asarray([start, n_real], jnp.int32),
            q.shape[-1] ** -0.5, True))
    return np.asarray(J.ragged_prefill_reference(
        *args, np.int32(start), n_real=np.int32(n_real)))


@pytest.mark.parametrize("lengths", [
    [0, 1, 8, 9, 32],       # 0, 1, ps, ps + 1, Tmax
    [0, 0, 0, 0, 0],        # empty batch
    [7, 8, 9, 15, 16],      # page boundaries
])
def test_decode_matches_jax_reference_and_kernel(lengths):
    rng = np.random.RandomState(0)
    q, kp, vp, pt, ln = _make_case(rng, 5, 3, 8, 8, 4, lengths)
    got = _port_decode(q, kp, vp, pt, ln)
    for kernel in (False, True):
        np.testing.assert_allclose(
            got, _jax_decode(q, kp, vp, pt, ln, kernel), atol=ATOL,
            rtol=RTOL)
    for s, l in enumerate(lengths):
        if l == 0:                       # the masked-row contract
            np.testing.assert_array_equal(got[s], 0.0)


@pytest.mark.parametrize("start,C,n_real", [
    (0, 8, 8),       # first chunk, page-aligned
    (13, 8, 8),      # starting mid-page (the COW suffix resume)
    (16, 8, 5),      # a partial tail chunk
    (8, 16, 3),      # mostly padding
])
def test_prefill_matches_jax_reference_and_kernel(start, C, n_real):
    rng = np.random.RandomState(10)
    H, D, ps = 3, 16, 8
    n_live = -(-(start + C) // ps)
    num_pages = 12
    kp = rng.randn(num_pages, H, ps, D).astype(np.float32)
    vp = rng.randn(num_pages, H, ps, D).astype(np.float32)
    row = np.zeros((4,), np.int32)
    row[:n_live] = rng.permutation(np.arange(1, num_pages))[:n_live]
    q = rng.randn(C, H, D).astype(np.float32)
    got = _port_prefill(q, kp, vp, row, start, n_real)
    for kernel in (False, True):     # rows past n_real are garbage
        want = _jax_prefill(q, kp, vp, row, start, n_real, kernel)
        np.testing.assert_allclose(got[:n_real], want[:n_real], atol=ATOL,
                                   rtol=RTOL)


def test_null_page_contents_never_leak():
    rng = np.random.RandomState(2)
    q, kp, vp, pt, ln = _make_case(rng, 4, 2, 8, 8, 4, [0, 3, 8, 20])
    base = _port_decode(q, kp, vp, pt, ln)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e9, -1e9
    np.testing.assert_array_equal(_port_decode(q, kp2, vp2, pt, ln), base)
    np.testing.assert_allclose(_jax_decode(q, kp2, vp2, pt, ln, True),
                               base, atol=ATOL, rtol=RTOL)


def test_partial_tail_page_masked():
    rng = np.random.RandomState(3)
    q, kp, vp, pt, ln = _make_case(rng, 2, 2, 8, 8, 2, [5, 11])
    base = _port_decode(q, kp, vp, pt, ln)
    page = pt[0, 0]                      # slot 0: positions 5..7 dead
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[page, :, 5:], vp2[page, :, 5:] = 123.0, -321.0
    np.testing.assert_array_equal(_port_decode(q, kp2, vp2, pt, ln), base)


def test_nan_past_length_does_not_leak_and_nan_inside_propagates():
    rng = np.random.RandomState(4)
    q, kp, vp, pt, ln = _make_case(rng, 3, 2, 8, 8, 3, [5, 12, 20])
    base = _port_decode(q, kp, vp, pt, ln)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[pt[1, 1], :, 4:] = np.nan        # slot 1: positions 12..15
    vp2[pt[1, 1], :, 4:] = np.nan
    got = _port_decode(q, kp2, vp2, pt, ln)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(_jax_decode(q, kp2, vp2, pt, ln, True),
                               got, atol=ATOL, rtol=RTOL)
    vp3 = vp.copy()
    vp3[pt[2, 0], :, 3] = np.nan         # slot 2, position 3: live
    got = _port_decode(q, kp, vp3, pt, ln)
    assert np.isnan(got[2]).all()
    np.testing.assert_array_equal(got[:2], base[:2])
    assert np.isnan(_jax_decode(q, kp, vp3, pt, ln, True)[2]).all()


def test_page_table_permutation_invariance():
    rng = np.random.RandomState(5)
    H, D, ps = 2, 8, 4
    tok_k = rng.randn(12, H, D).astype(np.float32)
    tok_v = rng.randn(12, H, D).astype(np.float32)
    q = rng.randn(1, H, D).astype(np.float32)
    outs = []
    for pages in ([1, 2, 3], [5, 2, 7]):
        kp = np.zeros((8, H, ps, D), np.float32)
        vp = np.zeros((8, H, ps, D), np.float32)
        for j, p in enumerate(pages):
            kp[p] = tok_k[j * ps:(j + 1) * ps].transpose(1, 0, 2)
            vp[p] = tok_v[j * ps:(j + 1) * ps].transpose(1, 0, 2)
        outs.append(_port_decode(q, kp, vp, np.asarray([pages], np.int32),
                                 np.asarray([12], np.int32)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_partial_chunk_unwritten_tail_nan_does_not_poison_live_rows():
    """A partial chunk's positions past q_start + n_real are unwritten and
    may hold a recycled page's NaN: V is selected out from q_start +
    n_real (not q_start + C), so live rows stay finite."""
    rng = np.random.RandomState(21)
    H, D, ps = 2, 8, 8
    start, n_real, C = 16, 3, 8
    kp = rng.randn(12, H, ps, D).astype(np.float32)
    vp = rng.randn(12, H, ps, D).astype(np.float32)
    row = np.asarray([4, 1, 8, 9], np.int32)   # 9: reserved, unwritten
    q = rng.randn(C, H, D).astype(np.float32)
    clean = _port_prefill(q, kp, vp, row, start, n_real)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[8, :, 3:], vp2[8, :, 3:] = np.nan, np.nan      # positions >= 19
    kp2[9], vp2[9] = np.nan, np.nan
    dirty = _port_prefill(q, kp2, vp2, row, start, n_real)
    assert np.isfinite(dirty[:n_real]).all()
    np.testing.assert_array_equal(dirty[:n_real], clean[:n_real])
    pal = _jax_prefill(q, kp2, vp2, row, start, n_real, True)
    np.testing.assert_allclose(pal[:n_real], dirty[:n_real], atol=ATOL,
                               rtol=RTOL)


def test_bf16_tracks_f32():
    rng = np.random.RandomState(6)
    q, kp, vp, pt, ln = _make_case(rng, 3, 2, 8, 8, 3, [1, 9, 24])
    ref = _port_decode(q, kp, vp, pt, ln)
    b16 = T.ragged_paged_attention(
        *(torch.tensor(a).bfloat16() for a in (q, kp, vp)),
        torch.tensor(pt), torch.tensor(ln))
    assert b16.dtype == torch.bfloat16
    np.testing.assert_allclose(b16.float().numpy(), ref, atol=0.05,
                               rtol=0.05)


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(7)
    q, kp, vp, pt, ln = _make_case(rng, 2, 2, 8, 8, 2, [3, 16])
    before = dict(T.LAUNCHES)
    args = [torch.tensor(a) for a in (q, kp, vp, pt, ln)]
    np.testing.assert_array_equal(T.ragged_paged_attention(*args).numpy(),
                                  _port_decode(q, kp, vp, pt, ln))
    T.ragged_prefill_attention(args[0], args[1], args[2], args[3][1], 8,
                               n_real=2)
    assert T.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    rng = np.random.RandomState(8)
    q, kp, vp, pt, ln = (torch.tensor(a) for a in
                         _make_case(rng, 2, 2, 8, 8, 2, [3, 16]))
    with pytest.raises(MXNetError, match="CUDA"):
        T._ragged_decode_cuda(q, kp, vp, pt, ln, 0.35)
    with pytest.raises(MXNetError, match="CUDA"):
        T._ragged_prefill_cuda(q, kp, vp, pt[1],
                               torch.tensor([8, 2], dtype=torch.int32), 0.35)


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the port builds nothing; the output directory lives in
    the checkout's build/kernels and is named by a hash of csrc/."""
    d = _build.build_dir()
    assert d.parent.name == "kernels" and d.parent.parent.name == "build"
    assert len(d.name) == 16
    assert set(_build.KERNELS) == {"ragged_decode", "ragged_prefill",
                                   "ragged_verify", "flash_fwd",
                                   "flash_bwd"}
    assert not _build._LIBS             # nothing loaded by the CPU tests


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, tol):
    rng = np.random.RandomState(9)
    q, kp, vp, pt, ln = (torch.tensor(a).to(cuda_device) for a in
                         _make_case(rng, 5, 3, 64, 16, 4, [0, 1, 16, 17,
                                                           64]))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = T.ragged_paged_attention(q, kp, vp, pt, ln)
    ref = T.ragged_attention_reference(q, kp, vp, pt, ln)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                               rtol=tol)
    row = pt[4]
    qc = q[:4].reshape(4 * 3, 64)[:8].reshape(8, 1, 64).expand(
        8, 3, 64).contiguous()
    got = T.ragged_prefill_attention(qc, kp, vp, row, 50, n_real=6)
    ref = T.ragged_prefill_reference(qc, kp, vp, row, 50, n_real=6)
    torch.testing.assert_close(got[:6].float(), ref[:6].float(), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------- #
# speculative verify window
# --------------------------------------------------------------------- #

def _verify_case(rng, lengths, W, H=3, D=16, ps=8, max_pages=6):
    """Random pools and a shuffled page table mapping each live slot's
    whole window (length + W - 1 positions)."""
    S = len(lengths)
    n_map = [-(-(l + W - 1) // ps) if l else 0 for l in lengths]
    P = 1 + sum(n_map)
    q = rng.randn(S, W, H, D).astype(np.float32)
    kp = rng.randn(P, H, ps, D).astype(np.float32)
    vp = rng.randn(P, H, ps, D).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((S, max_pages), np.int32)
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


def _port_verify(q, kp, vp, pt, ln, ks=None, vs=None):
    t = lambda a: None if a is None else torch.tensor(a)
    return T.ragged_verify_reference(t(q), t(kp), t(vp), t(pt), t(ln),
                                     k_scale=t(ks), v_scale=t(vs)).numpy()


def _jax_verify(q, kp, vp, pt, ln, dl=None, ks=None, vs=None,
                kernel=False):
    j = lambda a: None if a is None else jnp.asarray(a)
    if not kernel:
        return np.asarray(J.ragged_verify_reference(
            j(q), j(kp), j(vp), j(pt), j(ln), k_scale=j(ks), v_scale=j(vs)))
    sc = q.shape[-1] ** -0.5
    if ks is None:
        return np.asarray(J._ragged_verify_pallas(
            j(q), j(kp), j(vp), j(pt), j(ln), j(dl), sc, True))
    return np.asarray(J._ragged_verify_pallas_q(
        j(q), j(kp), j(vp), j(pt), j(ln), j(dl), j(ks), j(vs), sc, True))


def _consumed(got, want, dl):
    """Compare the rows a caller consumes (r <= draft_len)."""
    for s, d in enumerate(dl):
        np.testing.assert_allclose(got[s, :d + 1], want[s, :d + 1],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("W,dl", [(1, [0, 0, 0, 0, 0]),
                                  (3, [0, 2, 1, 2, 0]),
                                  (5, [0, 4, 2, 0, 3])])
def test_verify_matches_jax_reference_and_kernel(W, dl):
    """Mixed slots (dead, fresh, page boundaries, deep) with draft_len <
    W - 1 on some: every row equals JAX's reference, consumed rows its
    Pallas kernel; the dead slot is exactly zero."""
    rng = np.random.RandomState(40 + W)
    q, kp, vp, pt, ln = _verify_case(rng, [0, 1, 8, 13, 29], W)
    got = _port_verify(q, kp, vp, pt, ln)
    np.testing.assert_allclose(got, _jax_verify(q, kp, vp, pt, ln),
                               atol=ATOL, rtol=RTOL)
    dl = np.asarray(dl, np.int32)
    _consumed(got, _jax_verify(q, kp, vp, pt, ln, dl, kernel=True), dl)
    np.testing.assert_array_equal(got[0], 0.0)


def test_verify_w1_is_bitwise_the_decode_reference():
    rng = np.random.RandomState(41)
    q, kp, vp, pt, ln = _make_case(rng, 5, 2, 16, 8, 3, [0, 1, 8, 9, 24])
    dec = _port_decode(q, kp, vp, pt, ln)
    ver = _port_verify(q[:, None], kp, vp, pt, ln)
    np.testing.assert_array_equal(ver[:, 0], dec)
    out = T.ragged_verify_attention(*(torch.tensor(a) for a in
                                      (q[:, None], kp, vp, pt, ln)))
    np.testing.assert_array_equal(out.numpy()[:, 0], dec)


def test_verify_unwritten_tail_nan_does_not_poison_consumed_rows():
    """A slot drafting fewer than W - 1 tokens leaves [L + dl, L + W - 1)
    unwritten; a recycled page may hold NaN there. The plain version is
    per-row exact and the JAX kernel bounds V at L + dl: consumed rows
    stay finite and equal to the clean output."""
    rng = np.random.RandomState(42)
    W = 4
    q, kp, vp, pt, ln = _verify_case(rng, [4, 11], W)
    dl = np.asarray([0, 1], np.int32)
    clean = _port_verify(q, kp, vp, pt, ln)
    kp2, vp2 = kp.copy(), vp.copy()
    for s, (L, d) in enumerate(zip(ln, dl)):
        for pos in range(L + d, L + W - 1):
            kp2[pt[s, pos // 8], :, pos % 8] = np.nan
            vp2[pt[s, pos // 8], :, pos % 8] = np.nan
    dirty = _port_verify(q, kp2, vp2, pt, ln)
    for s, d in enumerate(dl):
        assert np.isfinite(dirty[s, :d + 1]).all()
        np.testing.assert_array_equal(dirty[s, :d + 1], clean[s, :d + 1])
    _consumed(_jax_verify(q, kp2, vp2, pt, ln, dl, kernel=True), clean, dl)


def test_verify_nan_inside_length_propagates_to_its_slot_only():
    rng = np.random.RandomState(43)
    q, kp, vp, pt, ln = _verify_case(rng, [5, 9], 3)
    clean = _port_verify(q, kp, vp, pt, ln)
    vp2 = vp.copy()
    vp2[pt[1, 0], :, 2] = np.nan          # slot 1, position 2: every row
    got = _port_verify(q, kp, vp2, pt, ln)
    assert np.isnan(got[1]).all()
    np.testing.assert_array_equal(got[0], clean[0])
    want = _jax_verify(q, kp, vp2, pt, ln)
    assert np.isnan(want[1]).all()
    vp3 = vp.copy()
    vp3[pt[0, 0], :, 5] = np.nan          # slot 0, position 5: rows >= 1
    got = _port_verify(q, kp, vp3, pt, ln)
    assert np.isfinite(got[0, 0]).all() and np.isnan(got[0, 1:]).all()


def test_verify_length_zero_and_permuted_page_table():
    rng = np.random.RandomState(44)
    q, kp, vp, pt, ln = _verify_case(rng, [3, 12], 3)
    np.testing.assert_array_equal(
        _port_verify(q, kp, vp, pt, np.zeros_like(ln)), 0.0)
    base = _port_verify(q, kp, vp, pt, ln)
    P = kp.shape[0]
    remap = np.concatenate([[0], rng.permutation(np.arange(1, P))])
    kpp, vpp = np.empty_like(kp), np.empty_like(vp)
    kpp[remap], vpp[remap] = kp, vp
    np.testing.assert_array_equal(
        _port_verify(q, kpp, vpp, remap[pt].astype(np.int32), ln), base)


# --------------------------------------------------------------------- #
# quantized pools: int8 / float8_e4m3 codes, one f32 scale per page
# --------------------------------------------------------------------- #

def _code_pools(rng, kp, vp, quant):
    """Code pools made from the float pools' shapes, as f32 arrays that
    both frameworks cast exactly (int8 integers; float8-representable
    values), plus random per-page scales."""
    P = kp.shape[0]
    if quant == "int8":
        codes = lambda: rng.randint(-127, 128, size=kp.shape).astype(
            np.float32)
    else:
        codes = lambda: np.asarray(jnp.asarray(
            np.clip(rng.randn(*kp.shape) * 64, -448, 448)).astype(
                jnp.float8_e4m3fn).astype(jnp.float32))
    scales = lambda: (rng.rand(P) * 0.02 + 0.005).astype(np.float32)
    return codes(), codes(), scales(), scales()


_JQ = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
_TQ = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_quantized_matches_jax_reference_and_kernel(kind, quant):
    rng = np.random.RandomState(50)
    if kind == "prefill":
        _, kp, vp, pt, _ = _make_case(rng, 1, 2, 8, 8, 4, [32])
    elif kind == "decode":
        q, kp, vp, pt, ln = _make_case(rng, 4, 2, 8, 8, 4, [0, 5, 16, 27])
    else:
        q, kp, vp, pt, ln = _verify_case(rng, [0, 5, 17], 3, H=2, D=8)
        dl = np.asarray([0, 2, 1], np.int32)
    kc, vc, ks, vs = _code_pools(rng, kp, vp, quant)
    jk, jv = (jnp.asarray(a).astype(_JQ[quant]) for a in (kc, vc))
    tk, tv = (torch.tensor(a).to(_TQ[quant]) for a in (kc, vc))
    tks, tvs = torch.tensor(ks), torch.tensor(vs)
    jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
    if kind == "decode":
        got = T.ragged_paged_attention(torch.tensor(q), tk, tv,
                                       torch.tensor(pt), torch.tensor(ln),
                                       k_scale=tks, v_scale=tvs).numpy()
        ref = J.ragged_attention_reference(
            jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(ln),
            k_scale=jks, v_scale=jvs)
        kern = J._ragged_pallas_q(jnp.asarray(q), jk, jv, jnp.asarray(pt),
                                  jnp.asarray(ln), jks, jvs, 8 ** -0.5, True)
        np.testing.assert_array_equal(got[0], 0.0)
    elif kind == "prefill":
        qc = rng.randn(8, 2, 8).astype(np.float32)
        got = T.ragged_prefill_attention(torch.tensor(qc), tk, tv,
                                         torch.tensor(pt[0]), 16, n_real=6,
                                         k_scale=tks, v_scale=tvs).numpy()
        ref = J.ragged_prefill_reference(
            jnp.asarray(qc), jk, jv, jnp.asarray(pt[0]), jnp.int32(16),
            n_real=6, k_scale=jks, v_scale=jvs)
        kern = J._ragged_prefill_pallas_q(
            jnp.asarray(qc), jk, jv, jnp.asarray(pt[0]),
            jnp.asarray([16, 6], jnp.int32), jks, jvs, 8 ** -0.5, True)
        got, ref, kern = got[:6], np.asarray(ref)[:6], np.asarray(kern)[:6]
    else:
        got = T.ragged_verify_attention(
            torch.tensor(q), tk, tv, torch.tensor(pt), torch.tensor(ln),
            torch.tensor(dl), k_scale=tks, v_scale=tvs).numpy()
        ref = _jax_verify(q, jk, jv, pt, ln, ks=ks, vs=vs)
        _consumed(got, _jax_verify(q, jk, jv, pt, ln, dl, ks, vs,
                                   kernel=True), dl)
        kern = None
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    if kern is not None:
        np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL,
                                   rtol=RTOL)


def test_nan_page_scale_masked_page_no_leak_live_page_propagates():
    """A code pool's NaN channel is the page scale: NaN on the null page
    or on a mapped page wholly past the length changes nothing; NaN on a
    live page makes exactly the slots that read it non-finite."""
    rng = np.random.RandomState(51)
    q, kp, vp, pt, ln = _make_case(rng, 3, 2, 8, 8, 4, [16, 16, 8])
    kc, vc, ks, vs = _code_pools(rng, kp, vp, "int8")
    pt[2, 1] = pt[1, 1]                  # slot 2 maps a page past length 8
    kc8, vc8 = (torch.tensor(a).to(torch.int8) for a in (kc, vc))

    def run(ks_, vs_):
        return T.ragged_attention_reference(
            torch.tensor(q), kc8, vc8, torch.tensor(pt), torch.tensor(ln),
            k_scale=torch.tensor(ks_), v_scale=torch.tensor(vs_)).numpy()

    clean = run(ks, vs)
    ks2, vs2 = ks.copy(), vs.copy()
    ks2[0] = vs2[0] = np.nan
    np.testing.assert_array_equal(run(ks2, vs2), clean)
    ks3 = ks.copy()
    ks3[pt[1, 1]] = np.nan               # live for slot 1, masked for 2
    got = run(ks3, vs)
    assert np.isnan(got[1]).all()
    np.testing.assert_array_equal(got[[0, 2]], clean[[0, 2]])
    want = np.asarray(J.ragged_attention_reference(
        jnp.asarray(q), jnp.asarray(kc).astype(jnp.int8),
        jnp.asarray(vc).astype(jnp.int8), jnp.asarray(pt), jnp.asarray(ln),
        k_scale=jnp.asarray(ks3), v_scale=jnp.asarray(vs)))
    assert np.isnan(want[1]).all()
    np.testing.assert_allclose(want[[0, 2]], got[[0, 2]], atol=ATOL,
                               rtol=RTOL)


def test_new_dispatchers_count_no_launch_and_wrappers_refuse_cpu():
    rng = np.random.RandomState(52)
    q, kp, vp, pt, ln = _verify_case(rng, [3, 9], 2, H=2, D=8)
    args = [torch.tensor(a) for a in (q, kp, vp, pt, ln)]
    dl = torch.tensor([1, 0], dtype=torch.int32)
    ks = torch.ones(kp.shape[0])
    kq = args[1].round().clamp(-127, 127).to(torch.int8)
    before = dict(T.LAUNCHES)
    T.ragged_verify_attention(*args, dl)
    T.ragged_verify_attention(args[0], kq, kq, args[3], args[4], dl,
                              k_scale=ks, v_scale=ks)
    assert T.LAUNCHES == before
    assert {"ragged_verify", "ragged_decode_q", "ragged_prefill_q",
            "ragged_verify_q"} <= set(T.LAUNCHES)
    with pytest.raises(MXNetError, match="CUDA"):
        T._ragged_verify_cuda(*args, dl, 0.35)
    with pytest.raises(MXNetError, match="CUDA"):
        T._ragged_decode_cuda(args[0][:, 0], kq, kq, args[3], args[4], 0.35,
                              ks, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cuda_verify_and_quantized_kernels_match_plain_versions(
        cuda_device, quant):
    rng = np.random.RandomState(53)
    q, kp, vp, pt, ln = _verify_case(rng, [0, 1, 16, 17, 40], 5, H=3, D=64,
                                     ps=16, max_pages=4)
    dl = torch.tensor([0, 4, 2, 0, 3], dtype=torch.int32,
                      device=cuda_device)
    dev = lambda a: torch.tensor(a).to(cuda_device)
    ks = vs = None
    if quant is not None:
        kc, vc, ks, vs = _code_pools(rng, kp, vp, quant)
        kp, vp = (dev(a).to(_TQ[quant]) for a in (kc, vc))
        ks, vs = dev(ks), dev(vs)
    else:
        kp, vp = dev(kp), dev(vp)
    q, pt, ln = dev(q), dev(pt), dev(ln)
    got = T.ragged_verify_attention(q, kp, vp, pt, ln, dl, k_scale=ks,
                                    v_scale=vs)
    ref = T.ragged_verify_reference(q, kp, vp, pt, ln, k_scale=ks,
                                    v_scale=vs)
    rows = torch.arange(5, device=cuda_device)[None, :] <= dl[:, None]
    torch.testing.assert_close(got[rows], ref[rows], atol=2e-5, rtol=2e-5)
    if quant is not None:
        got = T.ragged_paged_attention(q[:, 0].contiguous(), kp, vp, pt, ln,
                                       k_scale=ks, v_scale=vs)
        ref = T.ragged_attention_reference(q[:, 0], kp, vp, pt, ln,
                                           k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
        qc = q[4, :4].reshape(-1, 64)[:8].reshape(8, 1, 64).expand(
            8, 3, 64).contiguous()
        got = T.ragged_prefill_attention(qc, kp, vp, pt[4], 30, n_real=6,
                                         k_scale=ks, v_scale=vs)
        ref = T.ragged_prefill_reference(qc, kp, vp, pt[4], 30, n_real=6,
                                         k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got[:6], ref[:6], atol=2e-5, rtol=2e-5)
