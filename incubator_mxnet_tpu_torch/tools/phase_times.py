"""phase_times: run a checkout's ``chip_smoke.py`` with each of its
phases timed, to see where the script's wall time goes.

Usage (on the machine with the card):
    python incubator_mxnet_tpu_torch/tools/phase_times.py CHECKOUT \
        [--out FILE]

``CHECKOUT`` is the root of a checkout (this one or another, such as a
``git archive`` of an older commit): its ``chip_smoke.py`` is loaded as a
module, every module-level function named ``phase_*`` is wrapped in a
wall-clock timer, and its ``main()`` runs with that checkout first on
``sys.path``, so the checkout's own package is the one driven. The
script prints as it always does; then one line ``[phase_times] {...}``
with the seconds of each phase call in order (a phase called twice is
listed twice) and the total, also written to ``FILE`` as JSON. The
seconds are kept unrounded, so the phases of a run never sum past its
total. The exit code is ``main()``'s.

This file imports nothing of the package, so it can time any checkout.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys
import time


def _timed(name, fn, record):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record.append([name, time.perf_counter() - t0])
    return wrapper


def run(checkout: str, record: list):
    """``(rc, total seconds)`` of one run of ``checkout``'s
    chip_smoke.py; ``record`` gets ``[phase, seconds]`` as each phase
    call returns or raises."""
    root = os.path.abspath(checkout)
    path = os.path.join(root, "chip_smoke.py")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    os.chdir(root)
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    for name, fn in list(vars(mod).items()):
        if name.startswith("phase_") and callable(fn):
            setattr(mod, name, _timed(name[len("phase_"):], fn, record))
    sys.argv = [path]
    t0 = time.perf_counter()
    rc = mod.main()
    return rc, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out) if args.out else None
    record = []
    res = {"checkout": os.path.abspath(args.checkout), "rc": None,
           "total_s": None, "phases": record}
    try:
        res["rc"], res["total_s"] = run(args.checkout, record)
    finally:
        print(f"[phase_times] {json.dumps(res)}", flush=True)
        if out:
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
    return res["rc"]


if __name__ == "__main__":
    sys.exit(main())
