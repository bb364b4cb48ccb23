"""GPipe over pp and Switch MoE over ep across processes, on the CPU: four
gloo ranks started once through the unchanged ``tools/launch.py
--launcher local``, each running ``tests/test_torch_pipeline_moe_worker.py``
in one process group, held here against the JAX package on four of its
forced CPU devices (the same mesh) and against plain references:

  - ``pipeline_apply`` on pp4 (S = 4 stages, M = 8 microbatches of B = 2,
    F = 6, ``tests/test_parallel.py``'s case): the output against the
    JAX ``pipeline_apply`` on pp4 and the four stages applied in sequence
    (rtol 2e-5), the gradients of ``sum(out)`` for the stacked
    parameters and the input against JAX's and the sequence's (rtol
    5e-4 / atol 5e-5); fewer microbatches than stages and a leading
    dimension other than S refused with the JAX messages;
  - ``switch_moe`` on ep4 (N = 32 tokens, D = 8, E = 8, two experts a
    rank) with ample capacity and with drops: the output and the aux
    loss against the JAX ``switch_moe`` on that mesh and direct per-token
    routing in f32 (rtol 2e-5), the gradients of the experts, the router
    and the tokens against JAX's (rtol 5e-4 / atol 5e-5).

A rank's gradients are those of the sum of every rank's loss (the port's
convention); the worker averages them over the axis, which is one loss's
gradient. In one process: the virtual stages ``chip_smoke.py`` runs
(``gpipe_ticks`` with the list rotation) against the sequence, and
``switch_moe`` with no mesh against direct routing.

A rank that dies, or a run past its 300 s limit, fails the tests.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.parallel import mesh as jmesh
from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu.parallel import pipeline as jpl

from incubator_mxnet_tpu_torch import parallel
from incubator_mxnet_tpu_torch.parallel import pipeline as tpl

import test_torch_pipeline_moe_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 300


def _mesh(axes):
    return jmesh.build_mesh(devices=jax.devices()[:4], axis_sizes=axes)


def _sequential(stages, x):
    h = x
    for p in stages:
        h = w.stage_np(p, h)
    return h


def _jax_pipe():
    stages, x = w.pipe_inputs()
    jstages = [{k: jnp.asarray(v) for k, v in p.items()} for p in stages]
    stacked = jpl.stack_stage_params(jstages)
    mesh = _mesh({"pp": 4})

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    @jax.jit
    def run(sp, xx):
        out, vjp = jax.vjp(lambda a, b: jpl.pipeline_apply(
            stage_fn, a, b, mesh), sp, xx)
        return (out,) + vjp(jnp.ones_like(out))

    out, g, gx = run(stacked, jnp.asarray(x))

    def seq(plist, xx):
        h = xx
        for p in plist:
            h = jnp.tanh(h @ p["w"] + p["b"])
        return h.sum()

    gs, gsx = jax.grad(seq, argnums=(0, 1))(jstages, jnp.asarray(x))
    return dict(out=np.asarray(out), dw=np.asarray(g["w"]),
                db=np.asarray(g["b"]), dx=np.asarray(gx),
                seq_dw=np.stack([np.asarray(p["w"]) for p in gs]),
                seq_db=np.stack([np.asarray(p["b"]) for p in gs]),
                seq_dx=np.asarray(gsx))


def _jax_moe(tag):
    xs, logits, experts, cf = w.moe_inputs(tag == "drops")
    stacked = jmoe.stack_expert_params(
        [{"w": jnp.asarray(p["w"])} for p in experts])
    mesh = _mesh({"ep": 4})

    def expert_fn(p, h):
        return jnp.tanh(h @ p["w"])

    @jax.jit
    def run(sp, ll, xx):
        def loss(sp, ll, xx):
            o, a = jmoe.switch_moe(xx, ll, expert_fn, sp,
                                   capacity_factor=cf, mesh=mesh)
            return o.sum() + 0.01 * a, (o, a)
        (_, (o, a)), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(sp, ll, xx)
        return o, a, g

    out, aux, (gw, gl, gx) = run(stacked, jnp.asarray(logits),
                                 jnp.asarray(xs))
    return dict(out=np.asarray(out), aux=np.asarray(aux),
                dw=np.asarray(gw["w"]), dlogits=np.asarray(gl),
                dx=np.asarray(gx))


def _direct(xs, logits, experts, cf):
    """Per-token routing in f32: the argmax expert, its queue position
    against the capacity, gate x expert(token) or zero."""
    e_x = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e_x / e_x.sum(-1, keepdims=True)
    idx = probs.argmax(-1)
    C = max(1, int(np.ceil(xs.shape[0] / logits.shape[1] * cf)))
    seen = np.zeros(logits.shape[1], int)
    out = np.zeros_like(xs)
    for n in range(xs.shape[0]):
        e = idx[n]
        if seen[e] < C:
            out[n] = probs[n, e] * np.tanh(xs[n] @ experts[e]["w"])
        seen[e] += 1
    return out, int((seen - np.minimum(seen, C)).sum())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's ``(arrays, scalars)`` and the JAX references (built
    while the ranks run)."""
    out = str(tmp_path_factory.mktemp("pipemoe"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           "4", "--launcher", "local", "--", sys.executable,
           os.path.join(ROOT, "tests", "test_torch_pipeline_moe_worker.py"),
           out]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        ref = {"pipe": _jax_pipe(), "moe_ample": _jax_moe("ample"),
               "moe_drops": _jax_moe("drops")}
        log, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the four-rank run passed its {LIMIT_S} s limit:\n"
                    + log[-4000:])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        pytest.fail(f"a rank failed (exit {proc.returncode}):\n"
                    + log[-6000:])
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            scalars = json.load(f)
        ranks.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))),
                      scalars))
    return ranks, ref


def test_four_gloo_ranks(run):
    ranks, _ = run
    assert [s["world"] for _, s in ranks] == [4] * 4
    assert sorted(s["pp_index"] for _, s in ranks) == [0, 1, 2, 3]


def test_pipeline_apply_pp4_matches_jax_and_sequence(run):
    ranks, ref = run
    want = ref["pipe"]
    stages, x = w.pipe_inputs()
    seq = _sequential(stages, x)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["pipe/out"], want["out"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(arrays["pipe/out"], seq, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("part", ["w", "b", "x"])
def test_pipeline_apply_pp4_gradients(run, part):
    ranks, ref = run
    want = ref["pipe"]
    for arrays, _ in ranks:
        got = arrays[f"pipe/d{part}"]
        np.testing.assert_allclose(got, want[f"d{part}"], rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_allclose(got, want[f"seq_d{part}"], rtol=5e-4,
                                   atol=5e-5)


def test_pipeline_apply_refusals_match_jax(run):
    ranks, _ = run
    mesh = _mesh({"pp": 4})
    with pytest.raises(Exception) as few:
        jpl.pipeline_apply(lambda p, h: h, {"w": jnp.zeros((4, 2, 2))},
                           jnp.zeros((2, 1, 2)), mesh)
    with pytest.raises(Exception) as bad:
        jpl.pipeline_apply(lambda p, h: h, {"w": jnp.zeros((8, 2, 2))},
                           jnp.zeros((8, 1, 2)), mesh)
    for _, s in ranks:
        assert s["few_micro_error"] == str(few.value)
        assert s["bad_stack_error"] == str(bad.value)


@pytest.mark.parametrize("tag", ["ample", "drops"])
def test_switch_moe_ep4_matches_jax_and_direct(run, tag):
    ranks, ref = run
    want = ref[f"moe_{tag}"]
    xs, logits, experts, cf = w.moe_inputs(tag == "drops")
    direct, dropped = _direct(xs, logits, experts, cf)
    assert (dropped > 0) == (tag == "drops")
    for arrays, _ in ranks:
        out = arrays[f"moe_{tag}/out"]
        np.testing.assert_allclose(out, want["out"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out, direct, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(arrays[f"moe_{tag}/aux"], want["aux"],
                                   rtol=2e-5)
        if tag == "drops":
            assert int((np.abs(out).sum(-1) == 0).sum()) == dropped


@pytest.mark.parametrize("tag", ["ample", "drops"])
@pytest.mark.parametrize("part", ["dw", "dlogits", "dx"])
def test_switch_moe_ep4_gradients_match_jax(run, tag, part):
    ranks, ref = run
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays[f"moe_{tag}/{part}"],
                                   ref[f"moe_{tag}"][part], rtol=5e-4,
                                   atol=5e-5)


def test_virtual_stages_match_the_sequence():
    """The loop ``chip_smoke.py`` drives: every stage in one process, the
    hop a list rotation; output and gradients against the sequence."""
    stages, x = w.pipe_inputs()
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
              for p in stages]
    xt = torch.tensor(x, requires_grad=True)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    # the stages' masked outputs summed, as pipeline_apply's psum does
    out = torch.stack(tpl.gpipe_ticks(stage_fn, params, xt,
                                      list(range(w.S)), w.S)).sum(0)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               _sequential(stages, x), rtol=2e-5, atol=2e-5)
    h = torch.tensor(x, requires_grad=True)
    ref = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
           for p in stages]
    y = h
    for p in ref:
        y = stage_fn(p, y)
    y.sum().backward()
    for p, q in zip(params, ref):
        for k in p:
            np.testing.assert_allclose(p[k].grad.numpy(), q[k].grad.numpy(),
                                       rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(xt.grad.numpy(), h.grad.numpy(), rtol=5e-4,
                               atol=5e-5)


@pytest.mark.parametrize("tag", ["ample", "drops"])
def test_switch_moe_one_process_matches_direct(tag):
    xs, logits, experts, cf = w.moe_inputs(tag == "drops")
    params = parallel.stack_expert_params(
        [{"w": torch.tensor(p["w"])} for p in experts])
    out, aux = parallel.switch_moe(torch.tensor(xs), torch.tensor(logits),
                                   lambda p, h: torch.tanh(h @ p["w"]),
                                   params, capacity_factor=cf)
    direct, _ = _direct(xs, logits, experts, cf)
    np.testing.assert_allclose(out.numpy(), direct, rtol=2e-5, atol=2e-5)
    assert float(aux) > 0
