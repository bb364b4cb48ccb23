#!/usr/bin/env python3
"""Paired timing of the port's flash-attention kernels across source trees,
on one CUDA card.

    python3 tools/torch_flash_pair.py TREE [TREE ...] [--gpt] [--out FILE]

Each TREE is the root of a checkout of this repository (for instance a
``git archive`` of a commit unpacked into a directory that ``.gitignore``
lists). The trees run in the order given, each in a process of its own
started from its own root, so each builds its own kernels and imports its
own package: ``parent change change parent`` compares two versions in
turns on one card. In each process the tree's own ``chip_smoke.py``:

  - ``phase_device`` (the card's name and power limit) and
    ``phase_build`` (ptxas and SASS of every kernel; a failed check, such
    as a spill, is recorded as ``build_check`` and the run goes on);
  - ``flash_times`` at three shapes, bf16, H=12, D=64: bert_base's
    training batch (B=32, T=512, the lengths its batch draws, not
    causal), gpt_small's (B=16, T=512, every length 512, causal) and a
    long causal one (B=4, T=2048, every length 2048). Each kernel is
    first held against its plain version on those inputs, then timed
    with a cold L2 (median of 30): the kernel, the plain version and the
    library call (``scaled_dot_product_attention``; for dq and dk/dv its
    whole backward);
  - with ``--gpt``, ``phase_gpt_training`` (gpt_small bf16 B=16 T=512
    through the step graph: ms a step, one capture, 12 causal launches
    of each flash kernel a replay).

Prints a table of the runs side by side, with each tree's flash TMA
bodies as built (ptxas registers and spills, the nonzero SASS counts:
HMMA / HGMMA / LDSM / UTMALDG, and any wgmma pipeline ptxas serialized),
and writes every run's numbers and build lines as JSON to ``--out``
(default ``build/flash_pair.json``). Exits
non-zero if a run fails. Needs a CUDA card; it does not fall back.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

SHAPES = {                    # label: (B, T, lengths or None, causal)
    "bert": (32, 512, None, False),
    "gpt": (16, 512, [512] * 16, True),
    "long": (4, 2048, [2048] * 4, True),
}

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
shapes, gpt = json.loads(sys.argv[1]), sys.argv[2] == "1"
smi = cs.phase_device(torch)
res = {"card": smi, "kind": torch.cuda.get_device_name(0), "times": {},
       "max_abs_err": {}, "build_check": "passed"}
try:                          # a spill or a missing instruction is
    cs.phase_build()          # reported; the times are taken all the same
except cs.PhaseError as e:
    res["build_check"] = str(e)
    print(f"[pair] build check failed: {e}", flush=True)
for label, (B, T, lens, causal) in shapes.items():
    if lens is None:          # bert_batch's first draw from RandomState(0)
        lens = np.random.RandomState(0).randint(
            256, T + 1, size=B).tolist()
    err = {k: 0.0 for k in cs.FLASH}
    res["times"][label] = cs.flash_times(torch, B, T, lens, causal, err)
    res["max_abs_err"][label] = err
if gpt:
    st = cs.phase_gpt_training(torch, smi)
    res["gpt_training"] = {k: st[k] for k in (
        "ms_per_step", "tokens_per_s", "mfu", "step_trace_count",
        "launches", "losses") if k in st}
print("PAIR_RESULT " + json.dumps(res), flush=True)
"""


def run_tree(tree, gpt, timeout):
    """One tree's run in a process of its own; returns its result dict."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(SHAPES), "1" if gpt else "0"],
        cwd=tree, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    got = [ln for ln in lines if ln.startswith("PAIR_RESULT ")]
    if proc.returncode != 0 or not got:
        sys.stdout.write("\n".join(lines[-40:]) + "\n" + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    build = [ln for ln in lines
             if "_tma_kernel" in ln or ln.startswith("[pair] build check")]
    for ln in build:
        print(f"  {os.path.basename(tree)} {ln}")
    res = json.loads(got[-1][len("PAIR_RESULT "):])
    res["tree"], res["seconds"], res["build"] = tree, secs, build
    return res


def tma_builds(run):
    """{kernel: 'registers, spills; SASS counts'} of each flash TMA body
    from a run's build lines (ptxas -v and cuobjdump, as phase_build
    prints them), and ptxas's notes on a wgmma pipeline it serialized."""
    out = {}
    for ln in run.get("build", []):
        m = re.search(r"\[build\] flash_\w+ mxt::(\w+_tma_kernel): Used "
                      r"(\d+) registers.*?(\d+) bytes spill stores", ln)
        if m:
            out.setdefault(m.group(1), []).append(
                f"{m.group(2)} registers, {m.group(3)} B spilled")
        m = re.search(r"\[build\] sass mxt::(\w+_tma_kernel): (.*)", ln)
        if m:
            out.setdefault(m.group(1), []).append(", ".join(
                c for c in m.group(2).split(", ") if not c.endswith(" x0")))
        m = re.search(r"\((C75\d\d)\) Potential Performance Loss", ln)
        if m and "ptxas:" in ln:
            out.setdefault("ptxas", []).append(f"{m.group(1)} (wgmma "
                                               f"serialized)")
    return {k: "; ".join(v) for k, v in out.items()}


def table(runs):
    names = [os.path.basename(os.path.normpath(r["tree"])) for r in runs]
    print("\n[pair] " + " / ".join(names) + f" ({runs[0]['card']})")
    for label in SHAPES:
        B, T, _, causal = SHAPES[label]
        print(f"[pair] {label}: B={B} H=12 T={T} D=64 bf16 causal={causal}")
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            ms = [r["times"][label][k]["ms"] for r in runs]
            t = runs[0]["times"][label][k]
            print(f"[pair]   {k:14s} ms " + " / ".join(f"{x:.4f}" for x in ms)
                  + f"  (bound {t['bound_ms']:.4f} by {t['bound_by']}, "
                    f"library {t['library_ms']:.4f})")
        pair = [r["times"][label]["flash_bwd_dq"]["ms"] +
                r["times"][label]["flash_bwd_dkv"]["ms"] for r in runs]
        lib = [r["times"][label]["flash_bwd_dq"]["library_ms"] for r in runs]
        fwd_lib = [r["times"][label]["flash_fwd"]["library_ms"] for r in runs]
        print("[pair]   dq + dk/dv    ms " + " / ".join(f"{x:.4f}" for x in pair)
              + "  library backward " + " / ".join(f"{x:.4f}" for x in lib))
        print("[pair]   library fwd   ms " +
              " / ".join(f"{x:.4f}" for x in fwd_lib))
    for name, run in zip(names, runs):
        for kernel, what in tma_builds(run).items():
            print(f"[pair] build {name} {kernel}: {what}")
    if all("gpt_training" in r for r in runs):
        print("[pair] gpt_training ms a step " + " / ".join(
            f"{r['gpt_training']['ms_per_step']:.2f}" for r in runs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--gpt", action="store_true",
                    help="also time gpt_small's training step")
    ap.add_argument("--out", default="build/flash_pair.json")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a tree's run may take")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_pair: no CUDA device")
    runs = []
    for tree in args.trees:
        tree = os.path.abspath(tree)
        print(f"[pair] run {len(runs) + 1}: {tree}", flush=True)
        runs.append(run_tree(tree, args.gpt, args.timeout))
        print(f"[pair] run {len(runs)} done in {runs[-1]['seconds']:.1f} s",
              flush=True)
    table(runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    print(f"[pair] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
