"""A tiny, DETERMINISTIC supervised-training target: the port of the JAX
package's ``incubator_mxnet_tpu/train/example_target.py``.

Run as ``python -m incubator_mxnet_tpu_torch.train.example_target``
under a ``train.Supervisor``; configured entirely by environment
variables so the supervisor's argv stays trivial:

  MXTPU_TGT_CKPT_DIR     checkpoint root (required)
  MXTPU_TGT_RESULTS      jsonl loss log, one {"step","loss"} per line
  MXTPU_TGT_STEPS        total steps to train (default 24)
  MXTPU_TGT_SAVE_EVERY   snapshot cadence in steps (default 2)
  MXTPU_TGT_KILL_AT      comma list of step indices to kill -9 SELF at
                         (each fires once across restarts, via marker
                         files under the checkpoint root)
  MXTPU_TGT_HANG_AT      step index to hang (sleep) at — drives the
                         supervisor's zero-progress watchdog; fires
                         once, same marker protocol
  MXTPU_TGT_SEED         model/data seed (default 0)
  MXTPU_TGT_DEVICE       ``cpu`` trains on the CPU; otherwise on the
                         current context (``gpu(0)``)

The training itself is the resilience oracle: data for step ``s`` is
drawn from ``RandomState(seed + 1000 + s)``, so every run — killed,
resumed, or uninterrupted — computes the SAME loss at the same step
index, and a supervised run's per-step loss map equals an uninterrupted
run's bit for bit (the capsule restore contract, exercised through a
real ``kill -9`` and restart)."""

from __future__ import annotations

import json
import os
import time


def _env(name, default=None):
    v = os.environ.get(name)
    return default if v in (None, "") else v


def main() -> int:
    import numpy as np

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.amp.loss_scaler import LossScaler
    from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.train.chaos import KillSelf, SlowStep

    ckpt_dir = _env("MXTPU_TGT_CKPT_DIR")
    if not ckpt_dir:
        raise SystemExit("MXTPU_TGT_CKPT_DIR is required")
    results = _env("MXTPU_TGT_RESULTS")
    steps = int(_env("MXTPU_TGT_STEPS", 24))
    save_every = int(_env("MXTPU_TGT_SAVE_EVERY", 2))
    seed = int(_env("MXTPU_TGT_SEED", 0))
    kill_at = [int(s) for s in
               str(_env("MXTPU_TGT_KILL_AT", "")).split(",") if s]
    hang_at = _env("MXTPU_TGT_HANG_AT")
    ctx = mx.cpu() if _env("MXTPU_TGT_DEVICE") == "cpu" \
        else mx.current_context()

    with ctx:
        mx.random.seed(seed)
        net = nn.Sequential()
        net.add(nn.Dense(32, in_units=16, activation="relu"),
                nn.Dense(8, in_units=32))
        net.initialize()
        trainer = gluon.Trainer(
            net.collect_params(), "adam", {"learning_rate": 0.01},
            kvstore=None, loss_scaler=LossScaler(init_scale=4.0,
                                                 scale_window=50))

        injectors = [KillSelf(at_step=k,
                              marker=os.path.join(ckpt_dir, f"killed_{k}"))
                     for k in kill_at]
        if hang_at is not None:
            h = int(hang_at)
            marker = os.path.join(ckpt_dir, f"hung_{h}")
            if not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("hanging\n")
                injectors.append(SlowStep(start=h, end=h + 1,
                                          sleep_s=3600.0))

        manager = CheckpointManager(ckpt_dir, keep=3)
        start = 0
        if manager.latest_step() is not None:
            start = trainer.restore_checkpoint(manager)

        def batch(s):
            rng = np.random.RandomState(seed + 1000 + s)
            return (nd.array(rng.randn(16, 16).astype(np.float32)),
                    nd.array(rng.randn(16, 8).astype(np.float32)))

        def emit(rec):
            # per-line append: the file first APPEARS with the first
            # trained step, so the supervisor's progress signal never
            # ticks during cold start (the startup grace covers it)
            if results:
                with open(results, "a") as f:
                    f.write(json.dumps(rec) + "\n")

        for s in range(start, steps):
            for inj in injectors:
                inj.on_step_begin(s, trainer)
            x, y = batch(s)
            with autograd.record():
                L = ((net(x) - y) ** 2).mean()
            trainer.backward(L)
            trainer.step(x.shape[0])
            emit({"step": s, "loss": float(L.asnumpy()),
                  "outcome": str(trainer.last_outcome), "t": time.time()})
            if (s + 1) % save_every == 0 or s + 1 == steps:
                trainer.save_checkpoint(manager, step=s + 1)
        manager.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
