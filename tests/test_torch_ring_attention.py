"""Ring attention and ``block_attn_lse`` in one process on the CPU, against
the JAX package (its forced CPU devices).

  - ``block_attn_lse`` (the plain versions on the CPU) against the JAX
    ``block_attn_lse``: out, lse and the gradients of q, k, v within rtol
    1e-5 in f32, causal and not, ragged and zero lengths; the per-block
    backward from an outside ``(out, lse)`` (``block_attn_bwd``) against
    the JAX ``_dense_block_bwd``; a gated-off block (``valid_len`` 0 for
    the whole batch) gives zero out, lse -1e30 and exact zero gradients;
  - four virtual ranks of the flash ring (``flash_ring_fwd`` /
    ``flash_ring_bwd``, the loops the distributed ring runs, with every
    rank in this process and the blocks rotated between steps) against
    the JAX ``ring_flash_attention``
    (``interpret=False``) on a 4-device mesh, causal and not, values and
    gradients;
  - four virtual ranks of the plain ring (``plain_ring``, autograd
    through the steps) against the JAX ``ring_self_attention``:
    causal, global ``valid_length``, a fully masked row (exact zeros),
    values and gradients;
  - the distributed entry points on a ring of one (no process group):
    the whole sequence's attention, and ``active_ring_mesh`` is None
    outside an SPMD step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import pallas_attention as jpa
from incubator_mxnet_tpu.parallel import mesh as jmesh
from incubator_mxnet_tpu.parallel import ring_attention as jra

from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.parallel import ring_attention as ra

B, T, H, D, S = 2, 32, 2, 8, 4


@pytest.fixture(scope="module")
def mesh():
    return jmesh.build_mesh(devices=jax.devices()[:S], axis_sizes={"sp": S})


def _qkvg(seed, shape=(B, T, H, D)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _jax_vjp(fn, q, k, v, g):
    """``fn``'s output and its vjp at ``g`` as ONE jitted program (the
    eager shard_map rings compile op by op, ~10x slower)."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)
    return run(*(jnp.asarray(x) for x in (q, k, v, g)))


@pytest.mark.parametrize("causal,lens", [(False, [16, 9]), (True, [16, 16]),
                                         (False, [0, 5]), (True, [0, 16])])
def test_block_attn_lse_matches_jax(causal, lens):
    q, k, v, g = _qkvg(0, (B, H, 16, D))
    vl = np.array(lens, np.int32)

    def jf(q, k, v):
        return jpa.block_attn_lse(q, k, v, jnp.asarray(vl), causal)
    (jo, jl), vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(g), jnp.zeros_like(jl)))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    to, tl = fa.block_attn_lse(tq, tk, tv, torch.tensor(vl), causal)
    assert not tl.requires_grad
    to.backward(_t(g))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # the per-block backward from an outside (out, lse)
    bw = fa.block_attn_bwd(*(_t(x) for x in (q, k, v)), torch.tensor(vl),
                           to.detach(), tl, _t(g), causal)
    want = jpa._dense_block_bwd(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(vl), jnp.asarray(to.detach()),
                                jnp.asarray(tl.numpy()), jnp.asarray(g),
                                causal, None)
    for got, w in zip(bw, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_gated_off_block_is_zero_with_zero_gradients():
    q, k, v, g = _qkvg(1, (B, H, 8, D))
    vl = torch.zeros(B, dtype=torch.int32)
    out, lse = fa.block_attn_lse(_t(q), _t(k), _t(v), vl)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool((lse == -1e30).all())
    grads = fa.block_attn_bwd(_t(q), _t(k), _t(v), vl, out, lse, _t(g))
    for gr in grads:
        assert torch.equal(gr, torch.zeros_like(gr))
    # the merge weighs it at 0: a partial merged with it is unchanged
    o1, l1 = fa.block_attn_lse(_t(q), _t(k), _t(v),
                               torch.full((B,), 8, dtype=torch.int32))
    mo, ml = ra._merge_partials(o1, l1, out, lse)
    torch.testing.assert_close(mo, o1, rtol=0, atol=0)
    torch.testing.assert_close(ml, l1, rtol=0, atol=0)


def _blocks(a):
    """Rank n's (B, H, T/S, D) block of a (B, T, H, D) array."""
    return [b.transpose(1, 2).contiguous()
            for b in torch.tensor(a).split(T // S, dim=1)]


def _whole(blocks):
    return torch.cat([b.transpose(1, 2) for b in blocks], dim=1).numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_virtual_flash_ring_matches_jax(mesh, causal):
    q, k, v, g = _qkvg(7)

    def jf(q, k, v):
        return jra.ring_flash_attention(q, k, v, mesh=mesh, causal=causal,
                                        batch_axis=None)
    jo, jgrads = _jax_vjp(jf, q, k, v, g)
    qs, ks, vs = _blocks(q), _blocks(k), _blocks(v)
    res = ra.flash_ring_fwd(qs, ks, vs, causal)
    np.testing.assert_allclose(_whole([o for o, _ in res]), np.asarray(jo),
                               rtol=1e-5, atol=1e-6)
    grads = ra.flash_ring_bwd(qs, ks, vs, [o for o, _ in res],
                              [lse for _, lse in res], _blocks(g), causal)
    for j, want in enumerate(jgrads):
        np.testing.assert_allclose(_whole([gr[j] for gr in grads]),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,vl", [(False, None), (True, None),
                                       (False, [0, 20]), (True, [32, 11])])
def test_virtual_plain_ring_matches_jax(mesh, causal, vl):
    q, k, v, g = _qkvg(3)
    jvl = None if vl is None else jnp.asarray(vl, jnp.int32)

    def jf(q, k, v):
        return jra.ring_self_attention(q, k, v, mesh=mesh, causal=causal,
                                       batch_axis=None, valid_length=jvl)
    jo, jgrads = _jax_vjp(jf, q, k, v, g)
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    split = lambda x: list(x.split(T // S, dim=1))       # noqa: E731
    outs = ra.plain_ring(
        split(tq), split(tk), split(tv),
        None if vl is None else torch.tensor(vl), causal)
    out = torch.cat(outs, dim=1)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-6)
    if vl is not None and vl[0] == 0:
        # the fully masked row: exact zeros, finite
        assert torch.equal(out[0], torch.zeros_like(out[0]))
    for got, want in zip((tq, tk, tv), jgrads):
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_ring_of_one_is_whole_attention():
    q, k, v, _ = _qkvg(5)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    assert ra.active_ring_mesh(T) is None
    whole = fa.flash_attention_bhtd(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        torch.full((B,), T, dtype=torch.int32), True).transpose(1, 2)
    for fn in (ra.ring_self_attention, ra.ring_flash_attention):
        torch.testing.assert_close(fn(tq, tk, tv, causal=True), whole,
                                   rtol=1e-5, atol=1e-6)
