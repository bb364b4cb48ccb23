"""The ragged decode kernel's split plan and its tensor-core body.

``csrc/ragged_decode.cu`` takes its split plan from
``ops.ragged_attention.decode_plan``, a pure function of the step's shape
and the page row's capacity ``maxp * ps`` (each slot's length sits on the
device): the CPU tests hold the plan to its promises (every key of the
capacity in exactly one split, no split past it, whole 64-key tiles, at
most 16 splits, one cluster, about one wave of blocks on the tensor-core
body; the CUDA-core body's 64-key splits and exact scratch), check that a
CPU tensor still runs the plain version and counts no launch, and hold
the plain version against the JAX package's reference and its Pallas
kernels in interpret mode at the tensor-core body's shape (D = 64, page
16), raw and int8 / fp8 pools, f32 at 1e-5.

The ``cuda`` tests run the tensor-core body (bf16 queries, D = 64, raw /
int8 / fp8 pools) on a card against ``ragged_attention_reference``:
lengths 0, 1, 15, 16, 17, 63, 64, 65 and the capacity, at capacities of
1, 4, 64 and 128 pages; then the contract cases (NaN past the length and
in the null page, NaN inside it, length 0, a permuted page table, two
launches bitwise equal, a NaN page scale on a masked and on a live page)
and the refusal of a pool or query that is not 16-byte aligned.
Tolerance 1e-2 (atol and rtol): the output is bf16, and the body rounds p
to bf16 before P V (on code pools it keeps p * v_scale as a bf16 hi + lo
pair), where the Pallas kernel rounds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import ragged_attention as J
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import ragged_attention as T
from test_torch_ragged_verify import _moved, _poisoned


# --------------------------------------------------------------------- #
# the split plan (pure Python: runs here)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("maxp", [1, 4, 64, 128])
def test_plan_covers_the_capacity_in_whole_tiles(maxp, ps, tc):
    S, H, D = 8, 12, 64
    cap = maxp * ps
    for sms in (T.H100_SMS, 10_000):
        p = T.decode_plan(S, H, D, ps, maxp, tc, sms)
        assert p.tensor_cores == tc and p.keys == cap
        owner = [0] * cap
        for j in range(p.nsplit):
            k0 = j * p.split_keys
            assert k0 < cap, "a split starts at or past the capacity"
            for pos in range(k0, min(k0 + p.split_keys, cap)):
                owner[pos] += 1
        assert owner == [1] * cap
        assert p.blocks == S * H * p.nsplit
        if not tc:                # the CUDA-core pair, as before the plan
            assert p.split_keys == 64 and p.nsplit == -(-cap // 64)
            assert p.scratch_floats == S * H * p.nsplit * (D + 2)
            continue
        assert p.split_keys % 64 == 0 and p.scratch_floats == 0
        assert p.nsplit <= 16                       # one cluster
        if sms == T.H100_SMS:     # about one wave at the resident blocks
            assert p.nsplit == 1 or \
                p.blocks <= T._DECODE_BLOCKS_PER_SM * sms
        else:                     # a card wider than any plan: 64-key
            assert p.split_keys == 64 * -(-cap // 1024)   # splits up to
            assert p.nsplit == -(-cap // p.split_keys)    # 16 of them


def test_plan_at_chip_smoke_decode_shape():
    """S=8 slots of 12 heads at capacity 1024 on an H100: the split count
    tools/torch_ragged_sweep.py's decode mode chose; one slot: 16 splits
    of 64 keys."""
    p = T.decode_plan(8, 12, 64, 16, 64, True)
    assert (p.nsplit, p.split_keys, p.blocks) == (4, 256, 384)
    p = T.decode_plan(1, 12, 64, 16, 64, True)
    assert (p.nsplit, p.split_keys) == (16, 64)


# --------------------------------------------------------------------- #
# the CPU path: the plain version, against the JAX package
# --------------------------------------------------------------------- #

_TQ = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
_JQ = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
_LENGTHS = [0, 1, 15, 16, 17, 63, 64]


def _numpy_case(seed, quant, lengths=_LENGTHS, H=2, D=64, ps=16, maxp=4):
    """f32 queries, pools (codes as f32 values both frameworks cast
    exactly, with per-page scales, for a code pool) and a shuffled page
    table mapping each live slot's pages."""
    rng = np.random.RandomState(seed)
    n_map = [-(-L // ps) for L in lengths]
    P = 1 + sum(n_map)
    q = rng.randn(len(lengths), H, D).astype(np.float32)
    ks = vs = None
    if quant is None:
        kp, vp = (rng.randn(P, H, ps, D).astype(np.float32)
                  for _ in range(2))
    else:
        if quant == "int8":
            mk = lambda: rng.randint(-127, 128, (P, H, ps, D)).astype(
                np.float32)
        else:
            mk = lambda: np.asarray(jnp.asarray(np.clip(
                rng.randn(P, H, ps, D) * 64, -448, 448)).astype(
                    jnp.float8_e4m3fn).astype(jnp.float32))
        kp, vp = mk(), mk()
        ks, vs = ((rng.rand(P) * 0.02 + 0.005).astype(np.float32)
                  for _ in range(2))
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((len(lengths), maxp), np.int32)
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, pt, np.asarray(lengths, np.int32), ks, vs


@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_plain_decode_matches_jax_reference_and_pallas(quant):
    q, kp, vp, pt, ln, ks, vs = _numpy_case(70, quant)
    t = lambda a: None if a is None else torch.tensor(a)
    tk, tv = t(kp), t(vp)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    if quant is not None:
        tk, tv = tk.to(_TQ[quant]), tv.to(_TQ[quant])
        jk, jv = jk.astype(_JQ[quant]), jv.astype(_JQ[quant])
    got = T.ragged_paged_attention(t(q), tk, tv, t(pt), t(ln),
                                   k_scale=t(ks), v_scale=t(vs)).numpy()
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = J.ragged_attention_reference(j(q), jk, jv, j(pt), j(ln),
                                       k_scale=j(ks), v_scale=j(vs))
    sc = q.shape[-1] ** -0.5
    if quant is None:
        kern = J._ragged_pallas(j(q), jk, jv, j(pt), j(ln), sc, True)
    else:
        kern = J._ragged_pallas_q(j(q), jk, jv, j(pt), j(ln), j(ks), j(vs),
                                  sc, True)
    for want in (ref, kern):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(got[0], 0.0)      # length 0


@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch(quant):
    """bf16 queries at D = 64, the shape that takes the tensor-core body on
    a card: a CPU tensor runs the plain version and launches nothing."""
    q, kp, vp, pt, ln, ks, vs = _numpy_case(71, quant)
    t = lambda a: None if a is None else torch.tensor(a)
    tq = t(q).bfloat16()
    tk, tv = ((t(kp).bfloat16(), t(vp).bfloat16()) if quant is None else
              (t(kp).to(_TQ[quant]), t(vp).to(_TQ[quant])))
    before = dict(T.LAUNCHES)
    got = T.ragged_paged_attention(tq, tk, tv, t(pt), t(ln), k_scale=t(ks),
                                   v_scale=t(vs))
    assert T.LAUNCHES == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, T.ragged_attention_reference(
        tq, tk, tv, t(pt), t(ln), k_scale=t(ks), v_scale=t(vs)))


# --------------------------------------------------------------------- #
# the tensor-core body against the plain version (on a card only)
# --------------------------------------------------------------------- #

TOL = 1e-2
H_CARD = 12                  # gpt_small's heads: the serving plan's shape
CAPACITIES = [(1, 16), (4, 16), (64, 16), (128, 16)]   # (maxp, ps)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the decode kernel)")
    return torch.device("cuda")


def _card_case(dev, seed, maxp, ps, quant, lengths=None, extra=0):
    """bf16 queries, pools and a shuffled page table; each live slot maps
    its pages and ``extra`` positions' more (wholly masked pages), at most
    the page row. Default lengths: 0, 1, 15, 16, 17, 63, 64, 65 (at most
    the capacity) and the capacity."""
    cap = maxp * ps
    if lengths is None:
        lengths = [min(L, cap) for L in (0, 1, 15, 16, 17, 63, 64, 65)]
        lengths.append(cap)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_map = [min(maxp, -(-(L + extra) // ps)) if L else 0 for L in lengths]
    P = 1 + sum(n_map) + 2
    shape = (P, H_CARD, ps, 64)
    q = torch.randn(len(lengths), H_CARD, 64, generator=gen,
                    device=dev).bfloat16()
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
    pt = torch.zeros(len(lengths), maxp, dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n].int()
        used += n
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln, ks, vs


def _run(q, kp, vp, pt, ln, ks, vs):
    T.reset_launch_counts()
    out = T.ragged_paged_attention(q, kp, vp, pt, ln, k_scale=ks,
                                   v_scale=vs)
    torch.cuda.synchronize()
    key = "ragged_decode" + ("_q" if ks is not None else "")
    assert T.LAUNCHES[key] == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cuda_tensor_core_decode_matches_plain_version(cuda_device, quant):
    for maxp, ps in CAPACITIES:
        q, kp, vp, pt, ln, ks, vs = _card_case(cuda_device, 7 * maxp + ps,
                                               maxp, ps, quant)
        got = _run(q, kp, vp, pt, ln, ks, vs)
        ref = T.ragged_attention_reference(q, kp, vp, pt, ln, k_scale=ks,
                                           v_scale=vs)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL,
                                   rtol=TOL, msg=f"maxp={maxp} ps={ps}")
        assert (got[ln == 0] == 0).all()            # exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cuda_tensor_core_decode_contract_cases(cuda_device, quant):
    maxp, ps = 64, 16
    lengths = [0, 1, 17, 100, 255, 512, 777, 1024]
    q, kp, vp, pt, ln, ks, vs = _card_case(cuda_device, 43, maxp, ps, quant,
                                           lengths, extra=ps)
    clean = _run(q, kp, vp, pt, ln, ks, vs)
    # two launches bitwise equal (no atomics)
    assert torch.equal(clean, _run(q, kp, vp, pt, ln, ks, vs))
    # NaN past the length in every mapped page, and in the null page: the
    # output does not change
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, L in enumerate(lengths) if L
            for pos in range(L, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]
    got = _run(q, _poisoned(kp, past), _poisoned(vp, past), pt, ln, ks, vs)
    assert torch.equal(got, clean)
    # NaN inside the length (position 0 of slot 5; a float or fp8 pool)
    s = 5
    others = [i for i in range(len(lengths)) if i != s]
    if quant != "int8":
        got = _run(q, kp, _poisoned(vp, [(int(pt[s, 0]), 0)]), pt, ln, ks,
                   vs)
        assert torch.isnan(got[s].float()).all()
        assert torch.equal(got[others], clean[others])
    # length 0 everywhere: exact zeros
    assert (_run(q, kp, vp, pt, torch.zeros_like(ln), ks, vs) == 0).all()
    # a permuted page table over the same tokens
    P = kp.shape[0]
    remap = torch.zeros(P, dtype=torch.long, device=cuda_device)
    remap[1:] = torch.randperm(P - 1, device=cuda_device) + 1
    ptp = pt.clone()
    live = pt > 0
    ptp[live] = remap[pt[live].long()].int()
    moved = lambda x: None if x is None else _moved(x, remap)
    got = _run(q, moved(kp), moved(vp), ptp, ln, moved(ks), moved(vs))
    assert torch.equal(got, clean)
    if quant is None:
        return
    # a NaN page scale: on the null page and on slot 5's mapped page wholly
    # past its length it changes nothing; on a live page it reaches that
    # slot only
    masked = int(pt[s, 512 // ps])
    bad_k, bad_v = ks.clone(), vs.clone()
    for t in (bad_k, bad_v):
        t[0] = t[masked] = float("nan")
    assert torch.equal(_run(q, kp, vp, pt, ln, bad_k, bad_v), clean)
    for k_side in (True, False):
        bad = (ks if k_side else vs).clone()
        bad[int(pt[s, 0])] = float("nan")
        got = _run(q, kp, vp, pt, ln, bad if k_side else ks,
                   vs if k_side else bad)
        assert torch.isnan(got[s].float()).all()
        assert torch.equal(got[others], clean[others])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_cuda_decode_refuses_misaligned_operands(cuda_device, quant):
    """The tensor-core body copies 16 bytes at a time: a pool or a query
    one element off a 16-byte boundary is refused before any launch."""
    q, kp, vp, pt, ln, ks, vs = _card_case(cuda_device, 44, 4, 16, quant)

    def shifted(x):
        flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
        out = flat.view(torch.uint8)[x.element_size():][
            :x.numel() * x.element_size()].view(x.dtype).view(x.shape)
        out.view(torch.uint8).copy_(x.view(torch.uint8))
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    for args in ((shifted(q), kp, vp), (q, shifted(kp), vp),
                 (q, kp, shifted(vp))):
        T.reset_launch_counts()
        with pytest.raises(MXNetError, match="16-byte"):
            T.ragged_paged_attention(*args, pt, ln, k_scale=ks, v_scale=vs)
        assert not any(T.LAUNCHES.values())
