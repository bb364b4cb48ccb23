#!/usr/bin/env python3
"""Where the ragged decode, chunked-prefill and speculative-verify
kernels' time goes, on one CUDA card.

    python3 tools/torch_ragged_sweep.py [decode|prefill|verify|host ...]

Run from the root of a checkout on a machine with a CUDA card (the port's
kernels build for sm_90a). At chip_smoke.py's shapes (decode: S=8,
capacity 1024, lengths 0-1024; prefill: C=64; verify: S=8, W=5, capacity
1024; H=12, D=64, page 16, bf16 queries; raw and int8 pools, decode and
verify also fp8) it prints, with chip_smoke.py's timing (CUDA events, cold
L2, median of 30):

  - the floor of that timing: one elementwise op on one element;
  - each case at the split plan the wrapper takes and at other numbers
    of splits (prefill: the plan's ``sms`` argument, the chunk as a
    device span at each of chip_smoke.py's starts; decode and verify:
    16, 8, 4, 2 and 1 splits of the capacity), cold and warm L2;
  - from torch.profiler, the device time of each launched kernel per
    call, and the span from the first kernel's start to the last one's
    end;
  - ``host`` (not in the default set): the host time of one decode and
    one verify wrapper call at those shapes (the enqueue, from argument
    checks to the launch's return; the serving step is host-bound), and
    of one elementwise op for scale, median of 5 rounds of 2000 calls.

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_ragged_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(cs.phase_device(torch), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    nop = torch.empty(0, device="cuda")
    C, H, D, ps, maxp = (cs.PRE[k] for k in ("C", "H", "D", "ps", "maxp"))
    sc = D ** -0.5
    one = torch.zeros(1, device="cuda")
    print(f"[floor] one add_ on one element: "
          f"{cs._time_ms(torch, lambda: one.add_(1), flush):.4f} ms "
          f"(cold L2), {cs._time_ms(torch, lambda: one.add_(1), nop):.4f} "
          f"ms (warm)", flush=True)
    sms_real = torch.cuda.get_device_properties(0).multi_processor_count
    which = sys.argv[1:] or ["decode", "prefill", "verify"]
    if "host" in which:
        host_costs(torch, cs, ra, gen, sc)
    for kind in ("decode", "verify"):
        if kind in which:
            sweep_capacity(torch, cs, ra, kind, gen, flush, nop, sc,
                           profile, ProfilerActivity, DeviceType)
    if "prefill" not in which:
        return 0
    plan_fn = ra.prefill_plan
    for quant in (None, "int8"):
        for start, n_real in cs.PRE["cases"]:
            q, kp, vp, row, ks, vs, span = cs.prefill_case(
                torch, gen, torch.bfloat16, start, n_real, quant)
            for sms in (sms_real, 48, 12):
                plan = plan_fn(C, H, D, ps, maxp, True, sms)
                ra.prefill_plan = lambda *a, p=plan, **k: p
                try:
                    fn = lambda: ra._ragged_prefill_cuda(  # noqa: E731
                        q, kp, vp, row, span, sc, ks, vs)
                    cold = cs._time_ms(torch, fn, flush)
                    warm = cs._time_ms(torch, fn, nop)
                    span, per = profile_one(torch, fn, flush, profile,
                                            ProfilerActivity, DeviceType)
                finally:
                    ra.prefill_plan = plan_fn
                r = dict(kernel="prefill", pools=quant or "bf16",
                         start=start, n_real=n_real,
                         nsplit=plan.nsplit, split_keys=plan.split_keys,
                         blocks=plan.blocks, cold_ms=cold, warm_ms=warm,
                         span_ms=span, kernels_ms=per)
                print(f"[sweep] {json.dumps(r)}", flush=True)
    return 0


def sweep_capacity(torch, cs, ra, kind, gen, flush, nop, sc, profile,
                   ProfilerActivity, DeviceType):
    """The decode or verify kernel (tensor-core body) at chip_smoke's DEC
    or VER shapes, with the capacity cut into 16, 8, 4, 2 and 1 whole-tile
    splits besides the wrapper's own plan."""
    if kind == "decode":
        S, H, D, ps, maxp = (cs.DEC[k] for k in ("S", "H", "D", "ps",
                                                 "maxp"))
        plan_name, case_fn = "decode_plan", cs.decode_case
        launch, base = ra._ragged_decode_cuda, ra.decode_plan(
            S, H, D, ps, maxp, True)
    else:
        S, W, H, D, ps, maxp = (cs.VER[k] for k in ("S", "W", "H", "D",
                                                    "ps", "maxp"))
        plan_name, case_fn = "verify_plan", cs.verify_case
        launch, base = ra._ragged_verify_cuda, ra.verify_plan(
            S, W, H, D, ps, maxp, True)
    plan_fn = getattr(ra, plan_name)
    ktiles = -(-base.keys // 64)
    for quant in (None,) + cs.QUANTS:
        *head, ks, vs = case_fn(torch, gen, torch.bfloat16, quant)
        for n in (base.nsplit, 16, 8, 4, 2, 1):
            split_keys = 64 * -(-ktiles // n)
            nsplit = -(-base.keys // split_keys)
            plan = base._replace(split_keys=split_keys, nsplit=nsplit,
                                 blocks=S * H * nsplit)
            setattr(ra, plan_name, lambda *a, p=plan, **k: p)
            try:
                fn = lambda: launch(*head, sc, ks, vs)  # noqa: E731
                cold = cs._time_ms(torch, fn, flush)
                warm = cs._time_ms(torch, fn, nop)
                span, per = profile_one(torch, fn, flush, profile,
                                        ProfilerActivity, DeviceType)
            finally:
                setattr(ra, plan_name, plan_fn)
            r = dict(kernel=kind, pools=quant or "bf16",
                     planned=n == base.nsplit and plan == base,
                     nsplit=plan.nsplit, split_keys=plan.split_keys,
                     blocks=plan.blocks, cold_ms=cold, warm_ms=warm,
                     span_ms=span, kernels_ms=per)
            print(f"[sweep] {json.dumps(r)}", flush=True)


def host_costs(torch, cs, ra, gen, sc):
    """Host ms of one wrapper call, enqueue only: 2000 calls back to back
    (the card's work per call is shorter than the host's, so the queue
    never fills), timed before the closing synchronize; median of 5."""
    def host_ms(fn, n=2000):
        fn()                              # built, loaded and warm
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            rounds.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
        return statistics.median(rounds)

    one = torch.zeros(1, device="cuda")
    print(f"[host] one add_: {host_ms(lambda: one.add_(1)):.4f} ms",
          flush=True)
    for quant in (None, "int8"):
        *dec, ks, vs = cs.decode_case(torch, gen, torch.bfloat16, quant)
        *ver, ks2, vs2 = cs.verify_case(torch, gen, torch.bfloat16, quant)
        d = host_ms(lambda: ra._ragged_decode_cuda(*dec, sc, ks, vs))
        v = host_ms(lambda: ra._ragged_verify_cuda(*ver, sc, ks2, vs2))
        print(f"[host] pools {quant or 'bf16'}: decode {d:.4f} ms, verify "
              f"{v:.4f} ms a call", flush=True)


def profile_one(torch, fn, flush, profile, ProfilerActivity, DeviceType,
                n=20):
    """Per-call device ms of each kernel, and the mean span from the
    first kernel's start to the last kernel's end of one call (cold L2:
    the flush runs before each call, outside the span)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    per = {e.key[:60]: e.self_device_time_total / 1e3 / n
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "mxt::" in e.key}
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "mxt::" in e.name),
                 key=lambda e: e.time_range.start)
    spans, cur = [], []
    for e in evs:                         # group one call's kernels
        if cur and e.time_range.start - cur[-1].time_range.end > 100:
            spans.append(cur)
            cur = []
        cur.append(e)
    if cur:
        spans.append(cur)
    span = statistics.median(
        (c[-1].time_range.end - c[0].time_range.start) / 1e3 for c in spans)
    return span, per


if __name__ == "__main__":
    sys.exit(main())
