#!/usr/bin/env python3
"""Where the chunked-prefill and speculative-verify kernels' time goes,
on one CUDA card.

    python3 tools/torch_ragged_sweep.py [prefill|verify ...]

Run from the root of a checkout on a machine with a CUDA card (the port's
kernels build for sm_90a). At chip_smoke.py's shapes (prefill: C=64;
verify: S=8, W=5, capacity 1024; H=12, D=64, page 16, bf16 queries; raw
and int8 pools, verify also fp8) it prints, with chip_smoke.py's timing
(CUDA events, cold L2, median of 30):

  - the floor of that timing: one elementwise op on one element;
  - each case at the split plan the wrapper takes and at other numbers
    of splits (prefill: the plan's ``sms`` argument; verify: 16, 8, 4, 2
    and 1 splits of the capacity), cold and warm L2;
  - from torch.profiler, the device time of each launched kernel per
    call, and the span from the first kernel's start to the last one's
    end.

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
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
    which = sys.argv[1:] or ["prefill", "verify"]
    if "verify" in which:
        sweep_verify(torch, cs, ra, gen, flush, nop, sc, profile,
                     ProfilerActivity, DeviceType)
    if "prefill" not in which:
        return 0
    plan_fn = ra.prefill_plan
    for quant in (None, "int8"):
        for start, n_real in cs.PRE["cases"]:
            q, kp, vp, row, ks, vs = cs.prefill_case(
                torch, gen, torch.bfloat16, start, n_real, quant)
            for sms in (sms_real, 48, 12):
                plan = plan_fn(C, H, D, ps, maxp, start, n_real, True, sms)
                ra.prefill_plan = lambda *a, p=plan, **k: p
                try:
                    fn = lambda: ra._ragged_prefill_cuda(  # noqa: E731
                        q, kp, vp, row, start, n_real, sc, ks, vs)
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


def sweep_verify(torch, cs, ra, gen, flush, nop, sc, profile,
                 ProfilerActivity, DeviceType):
    """The verify kernel (tensor-core body) at chip_smoke's VER shapes,
    with the capacity cut into 16, 8, 4, 2 and 1 whole-tile splits."""
    S, W, H, D, ps, maxp = (cs.VER[k] for k in ("S", "W", "H", "D", "ps",
                                                "maxp"))
    plan_fn = ra.verify_plan
    base = plan_fn(S, W, H, D, ps, maxp, True)
    ktiles = -(-base.keys // 64)
    for quant in (None,) + cs.QUANTS:
        q, kp, vp, pt, ln, dl, ks, vs = cs.verify_case(
            torch, gen, torch.bfloat16, quant)
        for n in (base.nsplit, 16, 8, 4, 2, 1):
            split_keys = 64 * -(-ktiles // n)
            nsplit = -(-base.keys // split_keys)
            plan = base._replace(split_keys=split_keys, nsplit=nsplit,
                                 blocks=S * H * nsplit)
            ra.verify_plan = lambda *a, p=plan, **k: p
            try:
                fn = lambda: ra._ragged_verify_cuda(  # noqa: E731
                    q, kp, vp, pt, ln, dl, sc, ks, vs)
                cold = cs._time_ms(torch, fn, flush)
                warm = cs._time_ms(torch, fn, nop)
                span, per = profile_one(torch, fn, flush, profile,
                                        ProfilerActivity, DeviceType)
            finally:
                ra.verify_plan = plan_fn
            r = dict(kernel="verify", pools=quant or "bf16",
                     planned=n == base.nsplit and plan == base,
                     nsplit=plan.nsplit, split_keys=plan.split_keys,
                     blocks=plan.blocks, cold_ms=cold, warm_ms=warm,
                     span_ms=span, kernels_ms=per)
            print(f"[sweep] {json.dumps(r)}", flush=True)


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
