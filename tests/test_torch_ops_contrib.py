"""The port's contrib ops (``ops/contrib.py``: anchors, NMS, matching and
targets, ROI pooling, proposals, box codecs, deformable convolution,
count sketch, the Hawkes log-likelihood, mask targets) against the JAX
package on the CPU: every case of the table
(``tests/test_torch_op_cases.py``) at its stated rtol (bf16 at 1e-2),
the tied-score cases of ``box_nms`` and ``bipartite_matching`` exactly
(rtol 0), those of ``Proposal`` and ``MultiBoxTarget`` (padding rows,
hard negative mining) with their selections exact (the kept rows, their
order, the masks and class targets) and their targets within 2 ulps and
their boxes within 2e-7 of the image's extent (the two libraries'
``exp`` / ``log`` differ by an ulp), and each differentiable op's
gradient against ``jax.vjp`` of the JAX op at rtol 1e-5 (or the case's
rtol, where larger); plus the properties of ``tests/test_contrib_det.py``
through the port's ``nd`` and ``mx.sym``.
"""

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd

from test_torch_op_cases import CASES, case_ids, grad_names, host, ids
from torch_op_parity import case_outputs, gradient_equals_jax, op_equals_jax

CASE_IDS = case_ids("contrib")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", grad_names({"contrib"}))
def test_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)


@pytest.mark.parametrize("name,i", [(n, i) for n in ("MultiBoxTarget",
                                                     "Proposal")
                                    for i in range(len(CASES[n]))])
def test_tied_selections_are_exact(name, i):
    _, got, want = case_outputs(name, i, "float32")
    if name == "Proposal":
        g, w = host(got).astype(np.float32), host(want).astype(np.float32)
        np.testing.assert_array_equal(g[..., 0], w[..., 0])
        np.testing.assert_array_equal(g[..., 1:] == 0, w[..., 1:] == 0)
        # a box corner is a difference, cx - w / 2: its error is ulps of
        # the image's scale, not of the corner
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-7 * np.abs(w).max())
        return
    (bt, bm, ct), (wt, wm, wc) = ([host(x).astype(np.float32) for x in o]
                                  for o in (got, want))
    np.testing.assert_array_equal(bm, wm)
    np.testing.assert_array_equal(ct, wc)
    np.testing.assert_array_max_ulp(bt, wt, maxulp=2)


def _np_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    aa = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    ab = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    union = aa[:, None] + ab[None, :] - inter
    return np.where(union > 0, inter / union, 0)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with mx.cpu():
        yield


def test_box_iou_matches_numpy():
    rng = np.random.RandomState(0)
    a = np.sort(rng.rand(5, 2, 2), axis=-1).reshape(5, 4)[:, [0, 2, 1, 3]]
    b = np.sort(rng.rand(7, 2, 2), axis=-1).reshape(7, 4)[:, [0, 2, 1, 3]]
    got = nd.contrib.box_iou(nd.array(a), nd.array(b)).asnumpy()
    np.testing.assert_allclose(got, _np_iou(a, b), rtol=1e-5, atol=1e-6)


def test_multibox_prior_shapes_and_values():
    anchors = nd.contrib.MultiBoxPrior(nd.zeros((1, 8, 4, 4)),
                                       sizes=(0.5, 0.25), ratios=(1, 2),
                                       clip=True)
    assert anchors.shape == (1, 4 * 4 * 3, 4)
    a = anchors.asnumpy()[0]
    assert (a >= 0).all() and (a <= 1).all()
    np.testing.assert_allclose(a[0], [0, 0, 0.375, 0.375], atol=1e-6)


ROWS = np.array([[[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                  [0, 0.8, 0.12, 0.12, 0.52, 0.52],
                  [0, 0.7, 0.6, 0.6, 0.9, 0.9],
                  [1, 0.6, 0.1, 0.1, 0.5, 0.5]]], np.float32)


def test_box_nms_suppresses_overlaps():
    out = nd.contrib.box_nms(nd.array(ROWS), overlap_thresh=0.5,
                             coord_start=2, score_index=1,
                             id_index=0).asnumpy()[0]
    kept = out[:, 1][out[:, 1] > 0]
    assert len(kept) == 3 and 0.8 not in kept
    out2 = nd.contrib.box_nms(nd.array(ROWS), overlap_thresh=0.5,
                              coord_start=2, score_index=1, id_index=0,
                              force_suppress=True).asnumpy()[0]
    assert (out2[:, 1] > 0).sum() == 2


def test_box_nms_topk_stops_the_sweep_without_changing_it():
    """Rows at topk or later are never valid: the sweep that stops there
    equals the full sweep's result with those rows invalidated."""
    rng = np.random.RandomState(3)
    b = np.sort(rng.rand(40, 2, 2) * 0.6, -1).reshape(40, 4)[:, [0, 2, 1, 3]]
    rows = np.concatenate([np.zeros((40, 1)), rng.rand(40, 1), b], 1) \
        .astype(np.float32)[None]
    full = nd.contrib.box_nms(nd.array(rows), overlap_thresh=0.3,
                              id_index=0).asnumpy()[0]
    cut = nd.contrib.box_nms(nd.array(rows), overlap_thresh=0.3, id_index=0,
                             topk=7).asnumpy()[0]
    np.testing.assert_array_equal(cut[:, 2:], full[:, 2:])
    np.testing.assert_array_equal(cut[7:, :2], -1.0)
    np.testing.assert_array_equal(cut[:7, :2], full[:7, :2])


def test_box_nms_out_format_and_background():
    rows = np.array([[[0, 0.9, 0.25, 0.25, 0.2, 0.2],
                      [1, 0.8, 0.75, 0.75, 0.2, 0.2]]], np.float32)
    out = nd.contrib.box_nms(nd.array(rows), in_format="center",
                             out_format="corner", coord_start=2,
                             score_index=1, id_index=0,
                             background_id=0).asnumpy()[0]
    kept = out[out[:, 1] > 0]
    assert len(kept) == 1
    np.testing.assert_allclose(kept[0, 2:], [0.65, 0.65, 0.85, 0.85],
                               atol=1e-5)


def test_multibox_target_basic():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9],
                         [0.0, 0.0, 0.05, 0.05]]], np.float32)
    label = np.array([[[2, 0.12, 0.12, 0.42, 0.42],
                       [-1, 0, 0, 0, 0]]], np.float32)
    bt, bm, ct = nd.contrib.MultiBoxTarget(
        nd.array(anchors), nd.array(label),
        nd.array(np.zeros((1, 4, 3), np.float32)))
    ct = ct.asnumpy()[0]
    bm = bm.asnumpy()[0].reshape(3, 4)
    assert ct[0] == 3.0 and ct[1] == 0.0 and ct[2] == 0.0
    assert bm[0].sum() == 4 and bm[1].sum() == 0
    assert np.abs(bt.asnumpy()[0].reshape(3, 4)[0]).sum() > 0


def test_multibox_detection_decodes():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    cls_prob = np.array([[[0.1, 0.9], [0.8, 0.05], [0.1, 0.05]]],
                        np.float32)
    out = nd.contrib.MultiBoxDetection(
        nd.array(cls_prob), nd.array(np.zeros((1, 8), np.float32)),
        nd.array(anchors)).asnumpy()[0]
    valid = out[out[:, 0] >= 0]
    assert len(valid) == 1 and valid[0, 0] == 0.0
    assert abs(valid[0, 1] - 0.8) < 1e-5
    np.testing.assert_allclose(valid[0, 2:], [0.1, 0.1, 0.4, 0.4],
                               atol=1e-5)


def test_roi_align_uniform_feature_and_ramp():
    out = nd.contrib.ROIAlign(nd.array(np.full((1, 3, 16, 16), 2.5,
                                               np.float32)),
                              nd.array(np.array([[0, 2, 2, 10, 10]],
                                                np.float32)),
                              pooled_size=(4, 4)).asnumpy()
    assert out.shape == (1, 3, 4, 4)
    np.testing.assert_allclose(out, 2.5, atol=1e-5)
    ramp = np.broadcast_to(np.arange(8, dtype=np.float32), (1, 1, 8, 8))
    out = nd.contrib.ROIAlign(nd.array(ramp.copy()),
                              nd.array(np.array([[0, 0, 0, 7, 7]],
                                                np.float32)),
                              pooled_size=(7, 7),
                              sample_ratio=1).asnumpy()[0, 0]
    assert (np.diff(out.mean(axis=0)) > 0).all()


def test_ps_roi_align():
    data = np.zeros((1, 8, 4, 4), np.float32)
    for k in range(8):
        data[0, k] = k
    out = nd.contrib.ROIAlign(nd.array(data), nd.array(np.array(
        [[0, 0, 0, 3, 3]], np.float32)), pooled_size=(2, 2),
        position_sensitive=True).asnumpy()
    assert out.shape == (1, 2, 2, 2)
    for c in range(2):
        for i in range(2):
            for j in range(2):
                assert out[0, c, i, j] == pytest.approx(c * 4 + i * 2 + j)


def test_roi_pooling_max_semantics():
    data = np.zeros((1, 1, 8, 8), np.float32)
    data[0, 0, 3, 3] = 5.0
    out = nd.ROIPooling(nd.array(data), nd.array(np.array(
        [[0, 0, 0, 7, 7]], np.float32)), pooled_size=(2, 2)).asnumpy()
    assert out.max() == pytest.approx(5.0, abs=1e-4)


def test_proposal_shapes():
    rng = np.random.RandomState(0)
    out = nd.contrib.Proposal(
        nd.array(rng.rand(1, 18, 4, 4).astype(np.float32)),
        nd.array((rng.randn(1, 36, 4, 4) * 0.1).astype(np.float32)),
        nd.array(np.array([[64, 64, 1.0]], np.float32)),
        scales=(8, 16, 32), ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=50,
        rpn_post_nms_top_n=10).asnumpy()
    assert out.shape == (1, 10, 5)
    b = out[0, :, 1:]
    assert (b[:, 2] >= b[:, 0]).all()
    assert (b >= 0).all() and (b[:, [0, 2]] <= 64).all()


def test_box_nms_symbolic():
    rows = mx.sym.Variable("rows")
    s = mx.sym.contrib.box_nms(rows, overlap_thresh=0.5, coord_start=2,
                               score_index=1, id_index=0)
    exe = s.bind(mx.cpu(), args={"rows": nd.array(ROWS[:, :2])},
                 grad_req="null")
    out = exe.forward(is_train=False)[0].asnumpy()
    assert (out[0, :, 1] > 0).sum() == 1


def test_multibox_target_symbolic_three_outputs():
    s = mx.sym.contrib.MultiBoxTarget(mx.sym.Variable("a"),
                                      mx.sym.Variable("l"),
                                      mx.sym.Variable("p"))
    assert len(s.list_outputs()) == 3
    exe = s.bind(mx.cpu(), args={
        "a": nd.array(np.array([[[0.1, 0.1, 0.4, 0.4]]], np.float32)),
        "l": nd.array(np.array([[[0, 0.1, 0.1, 0.4, 0.4]]], np.float32)),
        "p": nd.zeros((1, 2, 1))}, grad_req="null")
    bt, bm, ct = exe.forward(is_train=False)
    assert ct.asnumpy().tolist() == [[1.0]] and bm.asnumpy().sum() == 4


def test_count_sketch_hawkes_mrcnn_mask_target():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16).astype(np.float32)
    h = rng.randint(0, 8, 16).astype(np.float32)
    s = rng.choice([-1.0, 1.0], 16).astype(np.float32)
    out = nd.contrib.count_sketch(nd.array(x), nd.array(h), nd.array(s),
                                  out_dim=8).asnumpy()
    want = np.zeros((2, 8), np.float32)
    for d in range(16):
        want[:, int(h[d])] += s[d] * x[:, d]
    np.testing.assert_allclose(out, want, rtol=1e-5)

    ll, _ = nd.contrib.hawkes_ll(
        nd.array([0.5]), nd.array([0.2]), nd.array([1.0]), nd.zeros((1, 1)),
        nd.zeros((1, 3)), nd.zeros((1, 3)), nd.array([0]), 4.0)
    np.testing.assert_allclose(ll.asnumpy(), [-2.0], rtol=1e-5)
    ll1, _ = nd.contrib.hawkes_ll(
        nd.array([0.5]), nd.array([0.2]), nd.array([1.0]), nd.zeros((1, 1)),
        nd.array([[1.0]]), nd.array([[0.0]]), nd.array([1]), 4.0)
    want1 = np.log(0.5) - 0.5 - (1.5 + 0.2 * (1 - np.exp(-3.0)))
    np.testing.assert_allclose(ll1.asnumpy(), [want1], rtol=1e-5)

    gmasks = np.zeros((1, 2, 8, 8), np.float32)
    gmasks[0, 0, :4] = 1.0
    t, w = nd.contrib.mrcnn_mask_target(
        nd.array(np.array([[[0, 0, 7, 7], [2, 2, 6, 6]]], np.float32)),
        nd.array(gmasks), nd.array(np.array([[0, 1]], np.float32)),
        nd.array(np.array([[1, 2]], np.float32)), num_classes=3,
        mask_size=(4, 4))
    assert t.shape == (1, 2, 3, 4, 4) and w.shape == (1, 2, 3, 4, 4)
    wn = w.asnumpy()
    assert wn[0, 0, 1].min() == 1.0 and wn[0, 0, 0].max() == 0.0


def test_deformable_convolution_v1_v2():
    """Zero offsets equal a plain convolution; an all-ones mask makes v2
    equal v1; gradients reach data, offsets and weights."""
    from incubator_mxnet_tpu_torch import autograd
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    off = np.zeros((2, 18, 5, 5), np.float32)
    ref = nd.Convolution(nd.array(x), nd.array(w), nd.array(b),
                         kernel=(3, 3), num_filter=6).asnumpy()
    out = nd.contrib.DeformableConvolution(
        nd.array(x), nd.array(off), nd.array(w), nd.array(b), kernel=(3, 3),
        num_filter=6).asnumpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    out2 = nd.contrib.ModulatedDeformableConvolution(
        nd.array(x), nd.array(off), nd.array(np.ones((2, 9, 5, 5),
                                                     np.float32)),
        nd.array(w), nd.array(b), kernel=(3, 3), num_filter=6).asnumpy()
    np.testing.assert_allclose(out2, ref, rtol=1e-4, atol=1e-4)
    xs = [nd.array(x), nd.array(off + 0.3), nd.array(w)]
    for t in xs:
        t.attach_grad()
    with autograd.record():
        y = nd.contrib.DeformableConvolution(*xs, nd.array(b), kernel=(3, 3),
                                             num_filter=6).sum()
    y.backward()
    assert all(float(np.abs(t.grad.asnumpy()).sum()) > 0 for t in xs)
