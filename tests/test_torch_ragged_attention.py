"""Ragged paged attention of the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
plain references and its Pallas kernels in interpret mode, and through
the port's plain PyTorch versions (the CPU path of
``incubator_mxnet_tpu_torch.ops.ragged_attention``). The contract cases
mirror tests/test_ragged_attention.py: null-page leak, partial tail
page, NaN past the length, NaN inside the length, length 0, page-table
permutation and the partial-chunk unwritten tail. f32 tolerance: atol
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
        T._ragged_prefill_cuda(q, kp, vp, pt[1], 8, 2, 0.35)


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the port builds nothing; the output directory lives in
    the checkout's build/kernels and is named by a hash of csrc/."""
    d = _build.build_dir()
    assert d.parent.name == "kernels" and d.parent.parent.name == "build"
    assert len(d.name) == 16
    assert set(_build.KERNELS) == {"ragged_decode", "ragged_prefill"}
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
