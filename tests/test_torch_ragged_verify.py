"""The speculative-verify kernel's split plan and its tensor-core body.

``csrc/ragged_verify.cu`` takes its split plan from
``ops.ragged_attention.verify_plan``, a pure function of the window's
shape and the page row's capacity ``maxp * ps`` (each slot's live keys,
``lengths + draft_len``, sit on the device): the CPU test holds the plan
to its promises (every key of the capacity in exactly one split, no split
past it, whole 64-key tiles and at most 16 splits, one cluster, and about
one wave of blocks on the tensor-core body; the CUDA-core body's exact
scratch).

The ``cuda`` tests run the tensor-core body (bf16 queries, D = 64, raw /
int8 / fp8 pools) on a card against ``ragged_verify_reference``: W in {1,
2, 5, 16, 17}, draft_len below W - 1 on some slots, lengths 0, 1, across
split and page boundaries and at the capacity, capacities of 1024 and
2048 keys (more than 16 64-key tiles: wider splits); then NaN past
lengths + draft_len (and in the null page), NaN inside the keys, a NaN
page scale on a masked and on a live page, a permuted page table, and two
launches bitwise equal. Tolerance 1e-2 (atol and rtol): the output is
bf16, and the body rounds p to bf16 before P V (on code pools it keeps p
* v_scale as a bf16 hi + lo pair), as the Pallas kernels round."""

import pytest
import torch

from incubator_mxnet_tpu_torch.ops import ragged_attention as T


# --------------------------------------------------------------------- #
# the split plan (pure Python: runs here)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("maxp", [1, 4, 64, 128])
def test_plan_covers_the_capacity_in_whole_tiles(maxp, ps, tc):
    S, W, H, D = 8, 5, 12, 64
    cap = maxp * ps
    for sms in (T.H100_SMS, 10_000):
        p = T.verify_plan(S, W, H, D, ps, maxp, tc, sms)
        assert p.tensor_cores == tc and p.keys == cap
        owner = [0] * cap
        for j in range(p.nsplit):
            k0 = j * p.split_keys
            assert k0 < cap, "a split starts at or past the capacity"
            for pos in range(k0, min(k0 + p.split_keys, cap)):
                owner[pos] += 1
        assert owner == [1] * cap
        assert p.blocks == S * H * p.nsplit
        if not tc:
            assert p.split_keys == 64
            assert p.scratch_floats == S * W * H * p.nsplit * (D + 2)
            continue
        assert p.split_keys % 64 == 0 and p.scratch_floats == 0
        assert p.nsplit <= 16                       # one cluster
        if sms == T.H100_SMS:     # about one wave: 3 blocks an SM
            assert p.nsplit == 1 or p.blocks <= 3 * sms
        else:                     # a card wider than any plan: 64-key
            assert p.split_keys == 64 * -(-cap // 1024)   # splits up to
            assert p.nsplit == -(-cap // p.split_keys)    # 16 of them


def test_plan_at_chip_smoke_verify_shape():
    """S=8 slots of 12 heads at capacity 1024 on an H100: 4 splits of 256
    keys (384 blocks, one wave); one slot: 16 splits of 64."""
    p = T.verify_plan(8, 5, 12, 64, 16, 64, True)
    assert (p.nsplit, p.split_keys, p.blocks) == (4, 256, 384)
    p = T.verify_plan(1, 5, 12, 64, 16, 64, True)
    assert (p.nsplit, p.split_keys) == (16, 64)


# --------------------------------------------------------------------- #
# the tensor-core body against the plain version (on a card only)
# --------------------------------------------------------------------- #

TOL = 1e-2
# (maxp, ps): capacities of 1024 keys (16 splits of 64) and 2048 (16 of 128)
CAPACITIES = [(64, 16), (128, 8), (128, 16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the verify kernel)")
    return torch.device("cuda")


def _lengths(W, maxp, ps):
    """Dead, fresh, page and split boundaries, deep, and at capacity."""
    cap = maxp * ps
    split = T.verify_plan(12, W, 2, 64, ps, maxp, True).split_keys
    return [0, 1, ps - 1, ps, ps + 1, split - 1, split, split + 1,
            2 * split + 3, cap // 2 + 5, cap - W, cap]


def _case(dev, seed, W, maxp, ps, quant, H=2, D=64):
    """bf16 queries, pools and a shuffled page table mapping each live
    slot's whole window (length + W - 1 positions, at most the page row);
    draft_len cycles through 0 .. W - 1 (below W - 1 on most slots)."""
    lengths = _lengths(W, maxp, ps)
    S = len(lengths)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_map = [min(maxp, -(-(L + W - 1) // ps)) if L else 0 for L in lengths]
    P = 1 + sum(n_map) + 2
    shape = (P, H, ps, D)
    q = torch.randn(S, W, H, D, generator=gen, device=dev).bfloat16()
    ks = vs = None
    if quant is None:
        kp, vp = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
    else:
        if quant == "int8":
            mk = lambda: torch.randint(-127, 128, shape, generator=gen,
                                       device=dev).to(torch.int8)
        else:
            mk = lambda: (torch.randn(shape, generator=gen, device=dev) *
                          64).clamp(-448, 448).to(torch.float8_e4m3fn)
        kp, vp = mk(), mk()
        ks, vs = (torch.rand(P, generator=gen, device=dev) * 0.02 + 0.005
                  for _ in range(2))
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = torch.zeros(S, maxp, dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n].int()
        used += n
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dl = torch.tensor([i % W for i in range(S)], dtype=torch.int32,
                      device=dev)
    return q, kp, vp, pt, ln, dl, ks, vs


def _poisoned(pool, cells):
    """A copy of ``pool`` with every (page, position) in ``cells`` made
    non-finite across heads and the head dim: NaN in a float pool, the
    e4m3 NaN code in an fp8 pool, and -128 (a code the writers never
    emit) in an int8 pool, whose NaN channel is the page scale. Written
    through a byte view (float8 indexing is not implemented everywhere)."""
    out = pool.view(torch.uint8).clone().view(pool.dtype)
    for pg, pos in cells:
        if pool.dtype in (torch.float32, torch.bfloat16):
            out[pg, :, pos] = float("nan")
        else:
            out.view(torch.uint8)[pg, :, pos] = \
                0x7F if pool.dtype == torch.float8_e4m3fn else 0x80
    return out


def _moved(x, remap):
    """Page p of ``x`` (a pool or a per-page scale) moved to remap[p]."""
    b = x.view(torch.uint8).reshape(x.shape[0], -1)
    out = b.clone()
    out[remap[1:]] = b[1:]
    return out.view(x.dtype).reshape(x.shape)


def _consumed(dl, W):
    return torch.arange(W, device=dl.device)[None, :] <= dl.long()[:, None]


def _run(q, kp, vp, pt, ln, dl, ks, vs):
    T.reset_launch_counts()
    out = T.ragged_verify_attention(q, kp, vp, pt, ln, dl, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    key = "ragged_verify" + ("_q" if ks is not None else "")
    assert T.LAUNCHES[key] == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("W", [1, 2, 5, 16, 17])
def test_cuda_tensor_core_body_matches_plain_version(cuda_device, W, quant):
    for maxp, ps in CAPACITIES:
        q, kp, vp, pt, ln, dl, ks, vs = _case(cuda_device, W * 7 + ps, W,
                                              maxp, ps, quant)
        got = _run(q, kp, vp, pt, ln, dl, ks, vs)
        ref = T.ragged_verify_reference(q, kp, vp, pt, ln, k_scale=ks,
                                        v_scale=vs)
        rows = _consumed(dl, W)
        g, r = got[rows].float(), ref[rows].float()
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL,
                                   msg=f"maxp={maxp} ps={ps}")
        # rows past draft_len and the dead slot (length 0) are exact zeros
        assert (got[~rows] == 0).all() and (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cuda_tensor_core_body_contract_cases(cuda_device, quant):
    W, maxp, ps = 5, 64, 16
    q, kp, vp, pt, ln, dl, ks, vs = _case(cuda_device, 41, W, maxp, ps,
                                          quant)
    rows = _consumed(dl, W)
    clean = _run(q, kp, vp, pt, ln, dl, ks, vs)
    # two launches bitwise equal (no atomics)
    assert torch.equal(clean, _run(q, kp, vp, pt, ln, dl, ks, vs))
    # NaN past length + draft_len in every mapped page, and in the null
    # page: the output does not change
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, (L, d) in enumerate(zip(ln.tolist(), dl.tolist())) if L
            for pos in range(L + d, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]
    got = _run(q, _poisoned(kp, past), _poisoned(vp, past), pt, ln, dl, ks,
               vs)
    assert torch.equal(got, clean)
    # NaN inside the keys (position 0 of slot 9, seen by every row; a
    # float or fp8 pool)
    s = 9
    others = [i for i in range(len(ln)) if i != s]
    if quant != "int8":
        got = _run(q, kp, _poisoned(vp, [(int(pt[s, 0]), 0)]), pt, ln, dl,
                   ks, vs)
        assert torch.isnan(got[s][rows[s]].float()).all()
        assert torch.equal(got[others], clean[others])
    # a permuted page table over the same tokens
    P = kp.shape[0]
    remap = torch.zeros(P, dtype=torch.long, device=cuda_device)
    remap[1:] = torch.randperm(P - 1, device=cuda_device) + 1
    ptp = pt.clone()
    live = pt > 0
    ptp[live] = remap[pt[live].long()].int()
    moved = lambda x: None if x is None else _moved(x, remap)
    got = _run(q, moved(kp), moved(vp), ptp, ln, dl, moved(ks), moved(vs))
    assert torch.equal(got, clean)
    if quant is None:
        return
    # a NaN page scale: on the null page and on a mapped page wholly past
    # length + draft_len it changes nothing; on a live page it reaches
    # that slot's consumed rows only
    s_m = next(i for i, (L, d) in enumerate(zip(ln.tolist(), dl.tolist()))
               if L and -(-(L + d) // ps) < int((pt[i] > 0).sum()))
    masked = int(pt[s_m, -(-(int(ln[s_m]) + int(dl[s_m])) // ps)])
    bad_k, bad_v = ks.clone(), vs.clone()
    for t in (bad_k, bad_v):
        t[0] = t[masked] = float("nan")
    got = _run(q, kp, vp, pt, ln, dl, bad_k, bad_v)
    assert torch.equal(got, clean)
    for k_side in (True, False):
        bad = (ks if k_side else vs).clone()
        bad[int(pt[s, 0])] = float("nan")
        got = _run(q, kp, vp, pt, ln, dl, bad if k_side else ks,
                   vs if k_side else bad)
        assert torch.isnan(got[s][rows[s]].float()).all()
        assert torch.equal(got[others], clean[others])
