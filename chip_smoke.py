#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100
is the target: the kernels build for sm_90a). Phases, in order; any
failure exits non-zero before the result line:

  1. device   — CUDA present; the card's name and power limit
                (nvidia-smi);
  2. build    — nvcc builds every kernel in incubator_mxnet_tpu_torch/
                csrc/ (in parallel), timed;
  3. kernels  — each kernel against its plain PyTorch version on the
                card at the serving path's shapes, f32 and bf16, plus the
                NaN / length-0 / page-permutation contract cases;
  4. serving  — gpt_small (GPT-2 small widths, bf16, seeded random
                weights) through InferenceEngine with chunked prefill and
                the prefix cache: ~16 requests, every kernel's launch
                count read around this run; then 10 decode steps at full
                occupancy under torch.profiler (device-busy share);
  5. parity   — at f32, the engine's greedy tokens equal the port's
                dense-cache cached_generate (which runs no kernel);
  6. times    — each kernel's device time (CUDA events around it, the
                host held ahead by a sleep kernel, cold L2, median), its
                plain version's, a library call's on the gathered
                window, and the bound from bytes / operations.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

DEC = dict(S=8, H=12, D=64, ps=16, maxp=64,
           lengths=[0, 1, 17, 100, 255, 512, 777, 1024])
PRE = dict(C=64, H=12, D=64, ps=16, maxp=64,
           cases=[(0, 64), (200, 37), (960, 64)])   # (start, n_real)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}   # atol, rtol
REPLACES = {
    "ragged_decode": "incubator_mxnet_tpu/ops/ragged_attention.py:75",
    "ragged_prefill": "incubator_mxnet_tpu/ops/ragged_attention.py:348",
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #

def decode_case(torch, gen, dtype):
    S, H, D, ps, maxp = (DEC[k] for k in ("S", "H", "D", "ps", "maxp"))
    lengths = DEC["lengths"]
    n_live = [-(-L // ps) for L in lengths]
    P = 1 + sum(n_live) + 3
    dev = "cuda"
    q = torch.randn(S, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, H, ps, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, H, ps, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = torch.zeros(S, maxp, dtype=torch.int32, device=dev)
    used = 0
    for s in range(S):
        pt[s, :n_live[s]] = perm[used:used + n_live[s]].int()
        used += n_live[s]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


def prefill_case(torch, gen, dtype, start, n_real):
    C, H, D, ps, maxp = (PRE[k] for k in ("C", "H", "D", "ps", "maxp"))
    n_live = -(-(start + C) // ps)
    P = 1 + maxp + 3
    dev = "cuda"
    q = torch.randn(C, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, H, ps, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, H, ps, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    row = torch.zeros(maxp, dtype=torch.int32, device=dev)
    row[:n_live] = perm[:n_live].int()
    return q, kp, vp, row


def decode_bytes_flops(lengths, H, D, elem):
    live = sum(lengths)
    S = len(lengths)
    nbytes = 2 * live * H * D * elem + 2 * S * H * D * elem + \
        S * DEC["maxp"] * 4 + S * 4
    flops = 4 * live * H * D
    return nbytes, flops


def prefill_bytes_flops(start, n_real, C, H, D, elem):
    keys = start + n_real
    nbytes = 2 * keys * H * D * elem + 2 * C * H * D * elem + \
        PRE["maxp"] * 4
    flops = sum(4 * (start + i + 1) * D * H for i in range(n_real))
    return nbytes, flops


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(line, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from incubator_mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, (t, log) in built.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {t:.1f} s  " + " | ".join(info[:4]),
              flush=True)
    print(f"[build] all kernels in {secs:.1f} s "
          f"({_build.build_dir()})", flush=True)


def phase_kernels(torch):
    """Kernel vs plain version on identical inputs; returns the largest
    |difference| per kernel over every compared case."""
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {"ragged_decode": 0.0, "ragged_prefill": 0.0}

    def cmp(name, got, ref, dtype_name, rows=None, what=""):
        g, r = got.float(), ref.float()
        if rows is not None:
            g, r = g[:rows], r[:rows]
        atol, rtol = TOL[dtype_name]
        d = (g - r).abs()
        ok = bool(torch.isfinite(g).all()) and \
            bool((d <= atol + rtol * r.abs()).all())
        e = float(d.max())
        err[name] = max(err[name], e)
        print(f"[kernels] {name} {dtype_name} {what}: max|err| {e:.3e} "
              f"(atol {atol}, rtol {rtol})", flush=True)
        check(ok, f"{name} {dtype_name} {what} disagrees with its plain "
                  f"version (max |err| {e:.3e})")

    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        q, kp, vp, pt, ln = decode_case(torch, gen, dt)
        got = ra._ragged_decode_cuda(q, kp, vp, pt, ln, DEC["D"] ** -0.5)
        ref = ra.ragged_attention_reference(q, kp, vp, pt, ln)
        torch.cuda.synchronize()
        cmp("ragged_decode", got, ref, dt_name, what="mixed lengths")
        check(bool((got[0] == 0).all()), "decode: length-0 slot not zero")
        for start, n_real in PRE["cases"]:
            q, kp, vp, row = prefill_case(torch, gen, dt, start, n_real)
            got = ra._ragged_prefill_cuda(q, kp, vp, row, start, n_real,
                                          PRE["D"] ** -0.5)
            ref = ra.ragged_prefill_reference(q, kp, vp, row, start,
                                              n_real=n_real)
            torch.cuda.synchronize()
            cmp("ragged_prefill", got, ref, dt_name, rows=n_real,
                what=f"start={start} n_real={n_real}")

    # contract cases, f32
    f32 = torch.float32
    sc = DEC["D"] ** -0.5
    q, kp, vp, pt, ln = decode_case(torch, gen, f32)
    clean = ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc)
    # NaN past a slot's length (tail of its last page) does not leak
    s, L, ps = 3, DEC["lengths"][3], DEC["ps"]
    last = int(pt[s, (L - 1) // ps])
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[last, :, L % ps:] = float("nan")
    vp2[last, :, L % ps:] = float("nan")
    kp2[0], vp2[0] = float("nan"), float("nan")          # the null page
    got = ra._ragged_decode_cuda(q, kp2, vp2, pt, ln, sc)
    check(bool(torch.equal(got, clean)),
          "decode: NaN past the length (or in the null page) leaked")
    # NaN inside the length propagates to that slot only
    vp3 = vp.clone()
    vp3[int(pt[5, 0]), :, 0] = float("nan")
    got = ra._ragged_decode_cuda(q, kp, vp3, pt, ln, sc)
    check(bool(torch.isnan(got[5]).all()), "decode: NaN inside the length "
                                           "did not propagate")
    others = [i for i in range(DEC["S"]) if i != 5]
    check(bool(torch.equal(got[others], clean[others])),
          "decode: NaN in one slot changed another")
    # length 0 everywhere gives exact zeros
    z = ra._ragged_decode_cuda(q, kp, vp, pt, torch.zeros_like(ln), sc)
    check(bool((z == 0).all()), "decode: length-0 slots not exactly zero")
    # page-table permutation invariance: same tokens, other pages
    perm_pt = pt.clone()
    P = kp.shape[0]
    new_ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    kpp, vpp = kp.clone(), vp.clone()
    remap = torch.zeros(P, dtype=torch.long, device="cuda")
    remap[1:] = new_ids
    kpp[remap[1:]] = kp[1:]
    vpp[remap[1:]] = vp[1:]
    live = pt > 0
    perm_pt[live] = remap[pt[live].long()].int()
    got = ra._ragged_decode_cuda(q, kpp, vpp, perm_pt, ln, sc)
    check(bool(torch.equal(got, clean)), "decode: page permutation changed "
                                         "the output")
    # prefill: a partial chunk's unwritten tail holding NaN
    start, n_real = PRE["cases"][1]
    q, kp, vp, row = prefill_case(torch, gen, f32, start, n_real)
    clean = ra._ragged_prefill_cuda(q, kp, vp, row, start, n_real, sc)
    end = start + n_real
    kp2, vp2 = kp.clone(), vp.clone()
    for pos in range(end, start + PRE["C"]):
        pg = int(row[pos // ps])
        kp2[pg, :, pos % ps] = float("nan")
        vp2[pg, :, pos % ps] = float("nan")
    got = ra._ragged_prefill_cuda(q, kp2, vp2, row, start, n_real, sc)
    check(bool(torch.isfinite(got[:n_real]).all()) and
          bool(torch.equal(got[:n_real], clean[:n_real])),
          "prefill: unwritten-tail NaN poisoned live rows")
    torch.cuda.synchronize()
    print("[kernels] contract cases: NaN past length, NaN inside length, "
          "length 0, page permutation, prefill unwritten tail: ok",
          flush=True)
    return err


def _time_ms(torch, fn, flush, iters=30):
    """Median device time of ``fn`` (ms) with a cold L2. A sleep kernel
    holds the stream while the host enqueues the events and ``fn``, so
    the events bracket device work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()                    # cold L2, as a real step sees
        torch.cuda._sleep(2_000_000)     # ~1 ms: the host runs ahead
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_times(torch):
    """Times at the serving path's shapes and dtype (bf16)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    dt, dt_name, elem = torch.bfloat16, "bfloat16", 2
    out = {}

    q, kp, vp, pt, ln = decode_case(torch, gen, dt)
    S, H, D, ps, maxp = (DEC[k] for k in ("S", "H", "D", "ps", "maxp"))
    sc = D ** -0.5
    K = maxp * ps
    kw = ra._gather_window(kp, pt)
    vw = ra._gather_window(vp, pt)
    mask = (torch.arange(K, device="cuda")[None, :] <
            ln.long()[:, None])[:, None, None, :]
    nb, fl = decode_bytes_flops(DEC["lengths"], H, D, elem)
    bms, by = bound(nb, fl, dt_name)
    out["ragged_decode"] = dict(
        ms=_time_ms(torch, lambda: ra._ragged_decode_cuda(
            q, kp, vp, pt, ln, sc), flush),
        plain_ms=_time_ms(torch, lambda: ra.ragged_attention_reference(
            q, kp, vp, pt, ln, sc), flush),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kw, vw, attn_mask=mask), flush),
        bound_ms=bms, bound_by=by,
        shape=f"S={S} H={H} D={D} ps={ps} maxp={maxp} "
              f"lengths={DEC['lengths']} bf16")

    C = PRE["C"]
    rows = []
    for start, n_real in PRE["cases"]:
        q, kp, vp, row = prefill_case(torch, gen, dt, start, n_real)
        kw = ra._gather_window(kp, row[None])[0]         # (H, K, D)
        vw = ra._gather_window(vp, row[None])[0]
        pos_q = start + torch.arange(C, device="cuda")[:, None]
        mask = torch.arange(K, device="cuda")[None, :] <= pos_q
        nb, fl = prefill_bytes_flops(start, n_real, C, H, D, elem)
        bms, by = bound(nb, fl, dt_name)
        rows.append(dict(
            ms=_time_ms(torch, lambda: ra._ragged_prefill_cuda(
                q, kp, vp, row, start, n_real, sc), flush),
            plain_ms=_time_ms(torch, lambda: ra.ragged_prefill_reference(
                q, kp, vp, row, start, sc, n_real), flush),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(0, 1)[None], kw[None], vw[None],
                attn_mask=mask), flush),
            bound_ms=bms, bound_by=by,
            shape=f"C={C} H={H} D={D} ps={ps} start={start} "
                  f"n_real={n_real} bf16"))
    for r in rows:
        print(f"[times] ragged_prefill {r['shape']}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.5f} by {r['bound_by']})", flush=True)
    out["ragged_prefill"] = rows[-1]                 # the deepest chunk
    r = out["ragged_decode"]
    print(f"[times] ragged_decode {r['shape']}: {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
          f"bound {r['bound_ms']:.5f} by {r['bound_by']})", flush=True)
    del flush
    return out


def _prompts(np, rng, vocab):
    """16 prompts of 64-768 tokens; 8 share a 512-token prefix. One
    shared-prefix request leads the first wave so the second wave's
    shared requests find the prefix cached."""
    prefix = rng.randint(0, vocab, size=512).astype(np.int32)
    shared = [np.concatenate([prefix, rng.randint(
        0, vocab, size=int(n)).astype(np.int32)])
        for n in rng.randint(16, 257, size=8)]
    other = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
             for n in rng.randint(64, 769, size=8)]
    return [shared[0]] + other[:7] + shared[1:] + other[7:]


def phase_serving(torch):
    import numpy as np
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Outcome,
                                                 Request)
    from incubator_mxnet_tpu_torch.events import EventType

    model = gpt_small(dtype="bfloat16", device="cuda", seed=0)
    eng = InferenceEngine(model, num_slots=8, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True)
    rng = np.random.RandomState(0)
    # warm-up: one short request (cuBLAS handles, allocator)
    eng.run([Request(rng.randint(0, 50257, size=40), max_new_tokens=4)])
    check(eng.health[Outcome.MAX_TOKENS.value] == 1, "warm-up failed")
    prompts = _prompts(np, rng, model.vocab_size)
    reqs = [Request(p, max_new_tokens=64, eos_id=50256,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=100 + i)
            for i, p in enumerate(prompts)]
    steps0, hits0 = eng.decode_steps, eng.prefix_hits
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = eng.decode_steps - steps0
    hits = eng.prefix_hits - hits0

    bad = [(r.request_id, r.outcome, r.detail) for r in reqs
           if r.outcome not in (Outcome.EOS, Outcome.MAX_TOKENS)]
    check(not bad, f"requests ended badly: {bad}")
    eng.audit_pages()
    check(hits > 0, "no prefix-cache hit")
    L = model.num_layers
    check(launches["ragged_decode"] == steps * L,
          f"decode kernel launches {launches['ragged_decode']} != decode "
          f"steps {steps} x {L} layers")
    check(launches["ragged_prefill"] > 0, "prefill kernel never launched")
    for r in reqs:
        check(all(0 <= t < model.vocab_size for t in r.token_ids),
              "token out of vocab")
    n_tok = sum(len(r.token_ids) for r in reqs)
    ttft = [r.token_stamps[0] - r.submit_time for r in reqs]
    dec = [e.data["dur_s"] for e in eng.flight.events(
        etype=EventType.DECODE_STEP)][-steps:]
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall,
                 ttft_p50_ms=statistics.median(ttft) * 1e3,
                 decode_ms_per_step=statistics.median(dec) * 1e3,
                 decode_steps=steps, prefix_hits=hits,
                 prefix_hit_tokens=eng.prefix_hit_tokens,
                 launches=launches)
    print(f"[serving] gpt_small bf16, 8 slots, chunk_pages=4: "
          f"{json.dumps(stats)}", flush=True)
    profile_decode(torch, np, eng, rng, Request)
    del eng, model
    torch.cuda.empty_cache()
    return stats


def profile_decode(torch, np, eng, rng, Request):
    """Where a full decode step's time goes: 8 slots at ~200 tokens of
    context, 10 steps under torch.profiler — device-busy time per step
    (kernel and copy time on the card) against the step's wall time,
    and the kernels that take it. Profiling adds host time, so the busy
    share printed is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(rng.randint(0, eng.model.vocab_size, size=200),
                    max_new_tokens=40) for _ in range(eng.num_slots)]
    for r in reqs:
        eng.submit(r)
    while any(sl is None or sl.prefilling for sl in eng._slots):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    eng.run([])
    eng.audit_pages()
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        print("[profile] device time not measured: the profiler recorded "
              "no kernel", flush=True)
        return
    busy_ms = sum(t for _, t in kern) / 1e3 / n
    top = sorted(kern, key=lambda kt: -kt[1])[:6]
    print(f"[profile] decode, 8 slots, ~200-240 context: wall "
          f"{wall_ms:.3f} ms/step (profiled), device busy {busy_ms:.3f} "
          f"ms/step ({100 * busy_ms / wall_ms:.1f}%); top: " + "; ".join(
              f"{k[:48]} {t / 1e3 / n:.3f} ms" for k, t in top), flush=True)


def phase_parity(torch):
    import numpy as np
    from incubator_mxnet_tpu_torch.models.gpt import (cached_generate,
                                                      gpt_small)
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    model = gpt_small(dtype="float32", device="cuda", seed=1)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, model.vocab_size, size=150).astype(np.int32)
    ref = cached_generate(model, torch.tensor(prompt[None], device="cuda"),
                          max_new_tokens=32)[0, prompt.size:].tolist()
    eng = InferenceEngine(model, num_slots=2, page_size=16, max_len=256,
                          chunk_pages=2, prefix_cache=True)
    req = Request(prompt, max_new_tokens=32)
    eng.run([req])
    eng.audit_pages()
    check(req.token_ids == ref,
          f"engine tokens {req.token_ids} != cached_generate {ref}")
    print(f"[parity] f32 gpt_small: engine == cached_generate over "
          f"{len(ref)} greedy tokens", flush=True)
    del eng, model
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script needs the GPU",
              file=sys.stderr)
        return 1
    try:
        import incubator_mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        phase_device(torch)
        phase_build()
        err = phase_kernels(torch)
        serving = phase_serving(torch)
        phase_parity(torch)
        times = phase_times(torch)
        for mod in ("jax", "incubator_mxnet_tpu"):
            check(mod not in sys.modules, f"{mod} was imported")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name in ("ragged_decode", "ragged_prefill"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": serving["launches"][name],
            "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
