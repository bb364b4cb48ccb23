"""The worker of ``tests/test_torch_pipeline_moe.py``: GPipe over pp4 and
Switch MoE over ep4, run once by each rank of a four-process gloo group
on the CPU.

Run through the unchanged launcher::

    python tools/launch.py -n 4 --launcher local -- \\
        python tests/test_torch_pipeline_moe_worker.py OUTDIR

Each rank writes ``OUTDIR/rank<r>.npz`` (its outputs and gradients, the
gradients averaged over the axis: the gradient of one rank's loss under
the port's convention) and ``rank<r>.json`` (its coordinate and the
refusals' messages). The module holds no test and imports neither JAX
nor the JAX package.
"""

import json
import os
import sys

import numpy as np

# tests/test_parallel.py's shapes
S, M, B, F = 4, 8, 2, 6
N, D, E = 32, 8, 8


def pipe_inputs():
    rng = np.random.RandomState(0)
    stages = [{"w": (rng.randn(F, F) * 0.4).astype(np.float32),
               "b": (rng.randn(F) * 0.1).astype(np.float32)}
              for _ in range(S)]
    x = rng.randn(M, B, F).astype(np.float32)
    return stages, x


def moe_inputs(drops):
    """``drops``: every token prefers expert 2 a little more, at capacity
    factor 0.5 (C = 2), so most tokens are dropped; else capacity factor
    8 (every token kept)."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, D).astype(np.float32)
    logits = rng.randn(N, E).astype(np.float32)
    if drops:
        logits[:, 2] += 2.0
    experts = [{"w": (rng.randn(D, D) * 0.3).astype(np.float32)}
               for _ in range(E)]
    return x, logits, experts, (0.5 if drops else 8.0)


def stage_np(p, h):
    return np.tanh(h @ p["w"] + p["b"])


def main(outdir):
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.parallel import collectives as coll

    arrays, scalars = {}, {}

    def mean_over(t, group):
        return coll.all_reduce_mean_(t.detach().clone(), group)

    with mx.cpu():
        parallel.initialize()
        rank = parallel.mesh.rank()
        scalars["world"] = parallel.mesh.world_size()

        # GPipe over pp4: outputs and the gradients of sum(out)
        mesh = parallel.build_mesh(axis_sizes={"pp": 4})
        group = parallel.mesh.axis_group(mesh, "pp")
        scalars["pp_index"] = parallel.mesh.axis_index(mesh, "pp")
        stages, x = pipe_inputs()
        stacked = parallel.stack_stage_params(
            [{k: torch.tensor(v) for k, v in p.items()} for p in stages])
        for v in stacked.values():
            v.requires_grad_(True)
        xt = torch.tensor(x, requires_grad=True)

        def stage_fn(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        out = parallel.pipeline_apply(stage_fn, stacked, xt, mesh)
        out.sum().backward()
        arrays["pipe/out"] = out.detach().numpy()
        for k, v in stacked.items():
            arrays[f"pipe/d{k}"] = mean_over(v.grad, group).numpy()
        arrays["pipe/dx"] = mean_over(xt.grad, group).numpy()
        for tag, fn in (
                ("few_micro", lambda: parallel.pipeline_apply(
                    stage_fn, stacked, xt[:2], mesh)),
                ("bad_stack", lambda: parallel.pipeline_apply(
                    stage_fn, {"w": torch.zeros(8, F, F)}, xt, mesh))):
            try:
                fn()
                scalars[f"{tag}_error"] = None
            except MXNetError as e:
                scalars[f"{tag}_error"] = str(e)

        # Switch MoE over ep4 (two experts a rank), ample capacity and
        # with drops: the output, the aux loss, the gradients of the
        # experts, the router and the tokens for sum(out) + 0.01 aux
        mesh = parallel.build_mesh(axis_sizes={"ep": 4})
        group = parallel.mesh.axis_group(mesh, "ep")
        for tag in ("ample", "drops"):
            xs, logits, experts, cf = moe_inputs(tag == "drops")
            xt = torch.tensor(xs, requires_grad=True)
            lt = torch.tensor(logits, requires_grad=True)
            params = parallel.stack_expert_params(
                [{"w": torch.tensor(p["w"])} for p in experts])
            params["w"].requires_grad_(True)
            out, aux = parallel.switch_moe(
                xt, lt, lambda p, h: torch.tanh(h @ p["w"]), params,
                capacity_factor=cf, mesh=mesh)
            (out.sum() + 0.01 * aux).backward()
            arrays[f"moe_{tag}/out"] = out.detach().numpy()
            arrays[f"moe_{tag}/aux"] = aux.detach().numpy()
            arrays[f"moe_{tag}/dw"] = mean_over(params["w"].grad,
                                                group).numpy()
            arrays[f"moe_{tag}/dlogits"] = mean_over(lt.grad, group).numpy()
            arrays[f"moe_{tag}/dx"] = mean_over(xt.grad, group).numpy()
        dist.barrier()

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)


if __name__ == "__main__":
    main(sys.argv[1])
