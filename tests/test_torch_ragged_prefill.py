"""The chunked-prefill kernel's split plan and its two bodies.

``csrc/ragged_prefill.cu`` takes its split plan from
``ops.ragged_attention.prefill_plan``, a pure function of the chunk's
shape and live keys: the CPU tests here hold the plan to its promises
(every live key in exactly one split, no split past the live keys, at
most 16 splits on the tensor-core body (one cluster), the CUDA-core
body's scratch exactly what its merge reads, about one block per SM at
the deepest serving chunk, no block that only exits at start 0). The plain
version is held against the JAX package's reference and its Pallas kernel
(interpret mode) at the shapes the kernel cases use: non-page-aligned
starts, partial chunks, page sizes 8 / 16 / 32, raw and int8 / fp8 code
pools (f32 tolerance 1e-5: both sides accumulate in f32, in different
orders).

The ``cuda`` tests run the kernel on a card against the plain version:
the tensor-core body (bf16, D = 64) and the CUDA-core body (f32 at D =
128; bf16 at D = 128), raw / int8 / fp8 pools, C in {1, 16, 37, 64, 128,
256}; the unwritten-tail NaN, a NaN page scale on a masked and on a live
page, NaN inside the live keys, the null page, rows past n_real written
as zeros, two launches bitwise equal, and every cluster size. Tolerances: f32 atol / rtol
2e-5 (summation order); bf16 1e-2 (the output is rounded to bf16; the
tensor-core body also rounds p to bf16 before P V, as the Pallas kernel
does, and on code pools keeps p * v_scale as a bf16 hi + lo pair)."""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import ragged_attention as T

ATOL = RTOL = 1e-5
_TQ = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}

# (C, q_start, n_real, page_size): the kernel cases
CASES = [
    (1, 0, 1, 16),
    (1, 37, 1, 8),
    (16, 5, 16, 8),
    (37, 200, 30, 16),
    (64, 0, 64, 32),
    (64, 333, 50, 32),
    (64, 960, 64, 16),
    (128, 41, 100, 8),
    (128, 700, 128, 16),
    (256, 100, 250, 16),
]


# --------------------------------------------------------------------- #
# the split plan (pure Python: runs here)
# --------------------------------------------------------------------- #

def _plan_cases():
    for C, start, n_real, ps in CASES + [(64, 0, 0, 16), (8, 17, 0, 8),
                                         (1024, 0, 1024, 16),
                                         (64, 4000, 64, 16)]:
        maxp = -(-(start + C) // ps)
        for tc, D in ((True, 64), (False, 128)):
            for H in (1, 4, 12):
                yield C, H, D, ps, maxp, start, n_real, tc


@pytest.mark.parametrize("C,H,D,ps,maxp,start,n_real,tc",
                         list(_plan_cases()))
def test_plan_covers_every_live_key_once(C, H, D, ps, maxp, start, n_real,
                                         tc):
    p = T.prefill_plan(C, H, D, ps, maxp, start, n_real, tc)
    assert p.keys == min(start + n_real, maxp * ps)
    assert p.nsplit >= 1 and p.split_keys > 0
    owner = np.zeros(max(p.keys, 1), np.int64)
    for j in range(p.nsplit):
        k0 = j * p.split_keys
        assert k0 < max(p.keys, 1), "a split starts at or past the keys"
        owner[k0:min(k0 + p.split_keys, p.keys)] += 1
    assert (owner[:p.keys] == 1).all()
    if tc:
        assert p.split_keys % 64 == 0
        assert p.q_tiles == (1 if C <= 64 else 2)
        assert p.nsplit <= 16               # one cluster per head
        tiles = -(-C // 64)
        groups = -(-tiles // p.q_tiles)
        assert p.blocks == p.nsplit * H * groups
    else:
        assert p.split_keys == 64 and p.q_tiles == 0
        assert p.blocks == -(-C // 16) * H * p.nsplit
    want = 0 if tc else n_real * H * p.nsplit * (D + 2)
    assert p.scratch_floats == want


def test_plan_fills_the_card_at_the_deepest_serving_chunk():
    """chip_smoke's deepest chunk (C=64 at start 960, gpt_small's 12 heads
    of 64, page 16, 64 pages): at least one block per SM of an H100, no
    scratch (the splits merge in their cluster)."""
    p = T.prefill_plan(64, 12, 64, 16, 64, 960, 64, True)
    assert p.blocks >= T.H100_SMS
    assert p.keys == 1024 and p.nsplit * p.split_keys >= 1024
    assert p.scratch_floats == 0
    # the middle case: only the live 237 keys are split
    p = T.prefill_plan(64, 12, 64, 16, 64, 200, 37, True)
    assert p.nsplit == 4 and p.blocks == 48
    # the CUDA-core body's scratch covers the live rows and splits only
    p = T.prefill_plan(64, 12, 64, 16, 64, 200, 37, False)
    assert p.nsplit == 4 and p.scratch_floats == 37 * 12 * 4 * 66


def test_plan_at_start_zero_launches_no_idle_block_and_no_merge():
    p = T.prefill_plan(64, 12, 64, 16, 64, 0, 64, True)
    assert (p.nsplit, p.blocks, p.scratch_floats) == (1, 12, 0)
    # a deeper card-filling plan only where the keys allow it
    p = T.prefill_plan(64, 12, 64, 16, 64, 0, 64, True, sms=10_000)
    assert p.nsplit == 1


def test_plan_grows_splits_with_the_keys_and_shrinks_with_more_sms():
    deep = T.prefill_plan(64, 12, 64, 16, 256, 3968, 64, True)
    assert deep.keys == 4032
    assert deep.split_keys > 64 and deep.blocks >= T.H100_SMS
    few = T.prefill_plan(64, 12, 64, 16, 256, 3968, 64, True, sms=12)
    assert few.nsplit == 1 and few.scratch_floats == 0
    many = T.prefill_plan(64, 12, 64, 16, 256, 3968, 64, True, sms=10_000)
    assert many.split_keys == 256 and many.nsplit == 16   # one cluster


def test_kernel_wrapper_refuses_cpu_tensors_before_planning():
    q = torch.zeros(4, 2, 64, dtype=torch.bfloat16)
    kp = torch.zeros(3, 2, 16, 64, dtype=torch.bfloat16)
    row = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(T.MXNetError, match="CUDA"):
        T._ragged_prefill_cuda(q, kp, kp, row, 3, 4, 0.125)


# --------------------------------------------------------------------- #
# the plain version against the JAX package at the kernel cases' shapes
# --------------------------------------------------------------------- #

def _case(rng, C, start, n_real, ps, H, D, extra_pages=2):
    """Random pools with the chunk's pages shuffled into a page row that
    covers [0, start + C), plus unmapped spare pages."""
    n_live = -(-(start + C) // ps)
    P = 1 + n_live + extra_pages
    kp = rng.randn(P, H, ps, D).astype(np.float32)
    vp = rng.randn(P, H, ps, D).astype(np.float32)
    row = np.zeros((n_live + 1,), np.int32)
    row[:n_live] = rng.permutation(np.arange(1, P))[:n_live]
    q = rng.randn(C, H, D).astype(np.float32)
    return q, kp, vp, row


def _codes(rng, shape, quant):
    if quant == "int8":
        return rng.randint(-127, 128, size=shape).astype(np.float32)
    x = np.clip(rng.randn(*shape) * 64, -448, 448).astype(np.float32)
    return torch.tensor(x).to(torch.float8_e4m3fn).float().numpy()


@pytest.mark.parametrize("C,start,n_real,ps", [
    (16, 5, 16, 8), (37, 200, 30, 16), (64, 333, 50, 32), (128, 41, 100, 8)])
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_plain_version_matches_jax_reference_and_kernel(C, start, n_real,
                                                        ps, quant):
    jnp = pytest.importorskip("jax.numpy")
    from incubator_mxnet_tpu.ops import ragged_attention as J
    rng = np.random.RandomState(C + ps)
    H, D = 2, 16
    q, kp, vp, row = _case(rng, C, start, n_real, ps, H, D)
    kw = dict(n_real=n_real)
    jkw = dict(n_real=np.int32(n_real))
    if quant is not None:
        kp, vp = _codes(rng, kp.shape, quant), _codes(rng, vp.shape, quant)
        ks = (rng.rand(kp.shape[0]) * 0.02 + 0.005).astype(np.float32)
        vs = (rng.rand(kp.shape[0]) * 0.02 + 0.005).astype(np.float32)
        tk, tv = (torch.tensor(a).to(_TQ[quant]) for a in (kp, vp))
        jdt = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}[quant]
        jk, jv = (jnp.asarray(a).astype(jdt) for a in (kp, vp))
        kw.update(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs))
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    else:
        tk, tv = torch.tensor(kp), torch.tensor(vp)
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    got = T.ragged_prefill_attention(torch.tensor(q), tk, tv,
                                     torch.tensor(row), start,
                                     **kw).numpy()[:n_real]
    jq, jrow = jnp.asarray(q), jnp.asarray(row)
    ref = J.ragged_prefill_reference(jq, jk, jv, jrow, np.int32(start),
                                     **jkw)
    qinfo = jnp.asarray([start, n_real], jnp.int32)
    if quant is None:
        kern = J._ragged_prefill_pallas(jq, jk, jv, jrow, qinfo, D ** -0.5,
                                        True)
    else:
        kern = J._ragged_prefill_pallas_q(jq, jk, jv, jrow, qinfo,
                                          jkw["k_scale"], jkw["v_scale"],
                                          D ** -0.5, True)
    for want in (ref, kern):
        np.testing.assert_allclose(got, np.asarray(want)[:n_real],
                                   atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------- #
# the kernel on a card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BODIES = [("bfloat16", 64), ("float32", 128), ("bfloat16", 128)]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _dev_case(dev, seed, C, start, n_real, ps, dtype, D, quant, H=4):
    rng = np.random.RandomState(seed)
    q, kp, vp, row = _case(rng, C, start, n_real, ps, H, D)
    dt = getattr(torch, dtype)
    ks = vs = None
    if quant is None:
        kp, vp = (torch.tensor(a).to(dev).to(dt) for a in (kp, vp))
    else:
        kp, vp = (torch.tensor(_codes(rng, kp.shape, quant)).to(dev)
                  .to(_TQ[quant]) for _ in range(2))
        ks, vs = (torch.tensor((rng.rand(kp.shape[0]) * 0.02 + 0.005)
                               .astype(np.float32)).to(dev)
                  for _ in range(2))
    return (torch.tensor(q).to(dev).to(dt), kp, vp,
            torch.tensor(row).to(dev), ks, vs)


def _run(q, kp, vp, row, start, n_real, ks, vs):
    return T.ragged_prefill_attention(q, kp, vp, row, start, n_real=n_real,
                                      k_scale=ks, v_scale=vs)


def _ref(q, kp, vp, row, start, n_real, ks, vs):
    return T.ragged_prefill_reference(q, kp, vp, row, start, n_real=n_real,
                                      k_scale=ks, v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("dtype,D", BODIES)
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, D, quant):
    tol = TOL[dtype]
    for i, (C, start, n_real, ps) in enumerate(CASES):
        args = _dev_case(cuda_device, 100 + i, C, start, n_real, ps, dtype,
                         D, quant)
        q, kp, vp, row, ks, vs = args
        before = dict(T.LAUNCHES)
        got = _run(q, kp, vp, row, start, n_real, ks, vs)
        key = "ragged_prefill" + ("_q" if quant else "")
        assert T.LAUNCHES[key] == before[key] + 1
        ref = _ref(q, kp, vp, row, start, n_real, ks, vs)
        torch.cuda.synchronize()
        what = f"C={C} start={start} n_real={n_real} ps={ps}"
        assert torch.isfinite(got[:n_real].float()).all(), what
        torch.testing.assert_close(got[:n_real].float(),
                                   ref[:n_real].float(), atol=tol,
                                   rtol=tol, msg=what)
        assert (got[n_real:] == 0).all(), what       # padded rows
        again = _run(q, kp, vp, row, start, n_real, ks, vs)
        assert torch.equal(got, again), what          # bitwise, run to run


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "fp8_e4m3"])
@pytest.mark.parametrize("dtype,D", BODIES)
def test_cuda_unwritten_tail_and_null_page_nan_do_not_leak(
        cuda_device, dtype, D, quant):
    """NaN K/V at positions [start + n_real, start + C) of a partial chunk,
    and a NaN null page, leave the live rows bitwise as they were."""
    nan = float("nan")
    for C, start, n_real, ps in [(37, 200, 30, 16), (64, 333, 50, 32),
                                 (128, 41, 100, 8)]:
        q, kp, vp, row, ks, vs = _dev_case(cuda_device, 7, C, start, n_real,
                                           ps, dtype, D, quant)
        clean = _run(q, kp, vp, row, start, n_real, ks, vs)
        kp2, vp2 = kp.clone(), vp.clone()
        for pos in range(start + n_real, start + C):
            pg = int(row[pos // ps])
            kp2[pg, :, pos % ps] = nan
            vp2[pg, :, pos % ps] = nan
        kp2[0], vp2[0] = nan, nan
        got = _run(q, kp2, vp2, row, start, n_real, ks, vs)
        assert torch.isfinite(got[:n_real].float()).all()
        assert torch.equal(got[:n_real], clean[:n_real])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dtype,D", BODIES)
def test_cuda_nan_page_scale_masked_page_no_leak_live_page_propagates(
        cuda_device, dtype, D, quant):
    C, start, n_real, ps = 64, 333, 50, 16
    q, kp, vp, row, ks, vs = _dev_case(cuda_device, 8, C, start, n_real,
                                       ps, dtype, D, quant)
    row = torch.cat([row, torch.zeros(2, dtype=torch.int32,
                                      device=cuda_device)])
    spare = min(set(range(1, kp.shape[0])) -
                set(row.tolist()))          # an unmapped page ...
    masked = (start + n_real) // ps + 1     # ... mapped wholly past 383
    assert masked * ps >= start + n_real
    row[masked] = spare
    clean = _run(q, kp, vp, row, start, n_real, ks, vs)

    def bad(s, page):
        s = s.clone()
        s[page] = float("nan")
        return s

    got = _run(q, kp, vp, row, start, n_real, bad(ks, spare),
               bad(vs, spare))
    assert torch.equal(got[:n_real], clean[:n_real])
    got = _run(q, kp, vp, row, start, n_real, bad(ks, 0), bad(vs, 0))
    assert torch.equal(got[:n_real], clean[:n_real])
    for k_bad in (True, False):              # page 0 of the row: all see it
        live = int(row[0])
        got = _run(q, kp, vp, row, start, n_real,
                   bad(ks, live) if k_bad else ks,
                   vs if k_bad else bad(vs, live))
        assert torch.isnan(got[:n_real].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", BODIES)
def test_cuda_nan_inside_the_live_keys_propagates(cuda_device, dtype, D):
    C, start, n_real, ps = 64, 960, 64, 16
    q, kp, vp, row, ks, vs = _dev_case(cuda_device, 9, C, start, n_real,
                                       ps, dtype, D, None)
    vp2 = vp.clone()
    vp2[int(row[0]), :, 0] = float("nan")    # position 0: every row sees it
    got = _run(q, kp, vp2, row, start, n_real, ks, vs)
    assert torch.isnan(got[:n_real].float()).all()
    ref = _ref(q, kp, vp2, row, start, n_real, ks, vs)
    assert torch.isnan(ref[:n_real].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_cuda_cluster_sizes_agree(cuda_device, quant, monkeypatch):
    """The tensor-core body at every cluster size it can take (1 = no
    merge, 2, 4, 8 portable, 16 non-portable), from the plan's ``sms``:
    the same chunk, the same answer within the bf16 tolerance."""
    plan_fn = T.prefill_plan
    C, start, n_real, ps = 64, 960, 64, 16
    q, kp, vp, row, ks, vs = _dev_case(cuda_device, 11, C, start, n_real,
                                       ps, "bfloat16", 64, quant)
    ref = _ref(q, kp, vp, row, start, n_real, ks, vs)[:n_real].float()
    seen = set()
    for sms in (4, 8, 16, 32, 64):
        def plan(*a, sms=sms):                  # the wrapper's shape args
            return plan_fn(*a[:8], sms=sms)
        monkeypatch.setattr(T, "prefill_plan", plan)
        seen.add(plan(C, 4, 64, ps, row.shape[0], start, n_real, True).nsplit)
        got = _run(q, kp, vp, row, start, n_real, ks, vs)
        torch.testing.assert_close(got[:n_real].float(), ref, atol=1e-2,
                                   rtol=1e-2)
    assert seen == {1, 2, 4, 8, 16}


@pytest.mark.cuda
def test_cuda_zero_live_rows_and_zero_rows(cuda_device):
    for dtype, D in BODIES:
        q, kp, vp, row, ks, vs = _dev_case(cuda_device, 10, 16, 40, 16, 8,
                                           dtype, D, None)
        got = _run(q, kp, vp, row, 40, 0, ks, vs)
        assert (got == 0).all()
        empty = _run(q[:0], kp, vp, row, 40, 0, ks, vs)
        assert empty.shape == (0, 4, D)
