"""Detection and other contrib operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/contrib.py``.

Every op keeps the JAX op's fixed shapes: suppression, matching and
filtering are masks, and a row that is suppressed or invalid carries the
reference's -1 sentinel. The JAX op's ``vmap`` over images is a batch
dimension here. Nothing reads the device back to the host or takes a
shape from data, so each op can run inside a captured CUDA graph (the SSD
training step runs ``MultiBoxTarget`` in one). A sequential JAX loop is a
Python loop issuing device ops: the greedy NMS sweep (``fori_loop``), the
bipartite matching of ``MultiBoxTarget`` and ``bipartite_matching``
(``lax.scan`` over the ground-truth rows / picks) and ``hawkes_ll``'s
recurrence over time.

Tie order decides outputs, so it is the JAX order: every sort whose order
reaches an output is stable (``jnp.argsort`` is), ``lax.top_k`` is a
stable descending sort and a slice (the lower index first among equals),
and an argmax takes the first maximum, as both libraries do.

On the card the backward of the gathers (``ROIAlign``, the deformable
convolutions' sampler) and ``count_sketch``'s scatter-add accumulate with
atomics, so their gradients are not bitwise from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import register
from .vision import _grid_sample_zero_pad

_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _corner_to_center(boxes):
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    return torch.stack([(xmin + xmax) / 2, (ymin + ymax) / 2,
                        xmax - xmin, ymax - ymin], dim=-1)


def _center_to_corner(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _pairwise_iou(lhs, rhs):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes -> (..., N, M)."""
    lt = torch.maximum(lhs[..., :, None, :2], rhs[..., None, :, :2])
    rb = torch.minimum(lhs[..., :, None, 2:], rhs[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (lhs[..., 2] - lhs[..., 0]).clamp(min=0.0) * \
        (lhs[..., 3] - lhs[..., 1]).clamp(min=0.0)
    area_r = (rhs[..., 2] - rhs[..., 0]).clamp(min=0.0) * \
        (rhs[..., 3] - rhs[..., 1]).clamp(min=0.0)
    union = area_l[..., :, None] + area_r[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _f32(v):
    """A Python number as the JAX op's f32 constant, exactly."""
    return float(np.float32(v))


def _take(x, idx):
    """``x[b, idx[b, n]]`` for x (B, N, *rest) and idx (B, K)."""
    shape = idx.shape + x.shape[2:]
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, index)


def _stable_top(scores, k):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU (reference: bounding_box.cc box_iou)."""
    if format == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    return _pairwise_iou(lhs, rhs)


@register("MultiBoxPrior", aliases=("multibox_prior",
                                    "_contrib_MultiBoxPrior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor generation (reference: multibox_prior.cc). ``data`` is the
    (B, C, H, W) feature map; returns (1, H*W*(S+R-1), 4) corner anchors
    in [0, 1] coordinates, (size_i, ratio_0) for every i, then
    (size_0, ratio_j) for j >= 1 at each cell."""
    sizes = tuple(sizes) if not isinstance(sizes, (int, float)) else (sizes,)
    ratios = tuple(ratios) if not isinstance(ratios, (int, float)) \
        else (ratios,)
    H, W = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cys, cxs = torch.meshgrid(cy, cx, indexing="ij")            # (H, W)
    wh = [(s * (ratios[0] ** 0.5), s / (ratios[0] ** 0.5)) for s in sizes]
    wh += [(sizes[0] * (r ** 0.5), sizes[0] / (r ** 0.5))
           for r in ratios[1:]]
    # half sizes as the JAX op's f32 table holds them; Python scalars, so
    # nothing is copied from the host (the op runs inside captured steps)
    anchors = torch.stack([
        torch.stack([cxs - w, cys - h, cxs + w, cys + h], dim=-1)
        for w, h in ((_f32(w) / 2.0, _f32(h) / 2.0) for w, h in wh)],
        dim=2)                                                  # (H,W,A,4)
    anchors = anchors.reshape(1, -1, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors


def _nms(boxes, scores, ids, overlap_thresh, valid_thresh, topk,
         force_suppress):
    """Greedy NMS of each image: boxes (B, N, 4), scores and ids (B, N).
    Returns the keep mask over the score order, and that order."""
    B, N = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    scores_s = torch.gather(scores, 1, order)
    valid = scores_s > valid_thresh
    # a row at topk or later is never valid, so it neither suppresses nor
    # survives: the sweep and its pair table stop at topk, and the result
    # is the JAX op's sweep over all N rows
    L = N if topk <= 0 else min(N, int(topk))
    if L < N:
        valid[:, L:] = False
    boxes_s = _take(boxes, order[:, :L])
    pair = _pairwise_iou(boxes_s, boxes_s) > overlap_thresh     # (B, L, L)
    if not force_suppress:
        ids_s = torch.gather(ids, 1, order[:, :L])
        pair &= ids_s[:, :, None] == ids_s[:, None, :]
    # row i suppresses a later row j only while i itself is kept and valid
    pair &= torch.ones(L, L, dtype=torch.bool, device=scores.device) \
        .triu(1)
    pair &= valid[:, :L, None]
    keep = torch.ones(B, L, dtype=torch.bool, device=scores.device)
    for i in range(L):
        keep &= ~(pair[:, i] & keep[:, i:i + 1])
    if L < N:
        keep = torch.cat([keep, keep.new_zeros(B, N - L)], dim=1)
    return keep & valid, order


@register("box_nms", aliases=("box_non_maximum_suppression",
                              "_contrib_box_nms"))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner",
            out_format="corner", background_id=-1):
    """Greedy non-maximum suppression (reference: bounding_box.cc).
    data: (B, N, K) rows [.., score, .., x1, y1, x2, y2, ..], returned in
    descending score order; a suppressed row gets score (and id) -1."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    boxes = data[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    scores = data[..., score_index]
    ids = data[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    if id_index >= 0 and background_id >= 0:
        # background-class rows never survive NMS (reference contract)
        scores = torch.where(ids == background_id, -1.0, scores)
    keep, order = _nms(boxes, scores, ids, overlap_thresh, valid_thresh,
                       topk, force_suppress)
    cols = list(_take(data, order).unbind(-1))
    if out_format != in_format:
        bx = _take(boxes, order)
        if out_format != "corner":
            bx = _corner_to_center(bx)
        cols[coord_start:coord_start + 4] = bx.unbind(-1)
    cols[score_index] = torch.where(keep, cols[score_index], -1.0)
    if id_index >= 0:
        cols[id_index] = torch.where(keep, cols[id_index], -1.0)
    out = torch.stack(cols, dim=-1)
    return out[0] if squeeze else out


@register("MultiBoxTarget", aliases=("multibox_target",
                                     "_contrib_MultiBoxTarget"),
          num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=_VARIANCES):
    """Anchor-to-ground-truth matching (reference: multibox_target.cc).

    anchor: (1, N, 4) corner; label: (B, M, 5) [cls x1 y1 x2 y2] with
    cls=-1 padding rows; cls_pred: (B, num_cls+1, N) (read only by hard
    negative mining). Returns (box_target (B, N*4), box_mask (B, N*4),
    cls_target (B, N))."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M, _ = label.shape
    dev = label.device
    a_center = _corner_to_center(anchors)
    gt_boxes = label[..., 1:5]
    iou = _pairwise_iou(anchors, gt_boxes)                       # (B, N, M)
    iou = torch.where((label[..., 0] >= 0)[:, None, :], iou, -1.0)

    # stage 1: greedy bipartite, one ground-truth row a round; each
    # round's best pair takes its anchor and its row out of the running
    rows = torch.arange(N, device=dev)
    gts = torch.arange(M, device=dev)
    matched = torch.full((B, N), -1, dtype=torch.long, device=dev)
    iou_w = iou
    for _ in range(M):
        flat = iou_w.reshape(B, -1).argmax(dim=1)
        ai, gi = flat // M, flat % M
        ok = torch.gather(iou_w.reshape(B, -1), 1, flat[:, None])[:, 0] \
            > 1e-12
        row = rows[None] == ai[:, None]
        matched = torch.where(row & ok[:, None], gi[:, None], matched)
        iou_w = torch.where(ok[:, None, None] & (
            row[:, :, None] | (gts[None, None] == gi[:, None, None])),
            -1.0, iou_w)

    # stage 2: anchors whose best IoU clears the threshold
    best_iou, best_gt = iou.max(dim=2)
    matched = torch.where((best_iou >= overlap_threshold) & (matched < 0),
                          best_gt, matched)

    is_pos = matched >= 0
    gi = matched.clamp(min=0)
    g_center = _corner_to_center(_take(gt_boxes, gi))
    v = [_f32(x) for x in variances]
    # the reference's variance-scaled offsets
    tx = (g_center[..., 0] - a_center[:, 0]) / a_center[:, 2] / v[0]
    ty = (g_center[..., 1] - a_center[:, 1]) / a_center[:, 3] / v[1]
    tw = torch.log(g_center[..., 2].clamp(min=1e-12) / a_center[:, 2]) \
        / v[2]
    th = torch.log(g_center[..., 3].clamp(min=1e-12) / a_center[:, 3]) \
        / v[3]
    box_t = torch.stack([tx, ty, tw, th], dim=-1) * is_pos[..., None]
    box_m = is_pos[..., None].expand(B, N, 4).to(torch.float32)
    cls_t = torch.where(is_pos, _take(label[..., 0], gi) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        # hard negative mining: among ELIGIBLE negatives (best IoU below
        # negative_mining_thresh), keep the ratio-capped hardest (lowest
        # background confidence); the count stays on the device and
        # truncates toward zero, as the JAX op's astype(int32)
        eligible = ~is_pos & (best_iou < negative_mining_thresh)
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]           # (B, N)
        num_pos = is_pos.sum(dim=1)
        max_neg = (negative_mining_ratio * num_pos).to(torch.int32) \
            .clamp(min=minimum_negative_samples)
        neg_scores = torch.where(eligible, bg_prob, float("inf"))
        rank = torch.argsort(torch.argsort(neg_scores, dim=1, stable=True),
                             dim=1, stable=True)
        keep_neg = eligible & (rank < max_neg[:, None])
        cls_t = torch.where(is_pos | keep_neg, cls_t, float(ignore_label))
    return box_t.reshape(B, -1), box_m.reshape(B, -1), cls_t


@register("MultiBoxDetection", aliases=("multibox_detection",
                                        "_contrib_MultiBoxDetection"))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=_VARIANCES, nms_topk=-1):
    """Decode + per-class NMS (reference: multibox_detection.cc).

    cls_prob: (B, num_cls+1, N) softmax probabilities (class 0
    background); loc_pred: (B, N*4); anchor: (1, N, 4). Returns (B, N, 6)
    rows [class_id, score, x1, y1, x2, y2], an invalid row's class_id
    -1."""
    B, C1 = cls_prob.shape[:2]
    N = anchor.shape[1]
    v = [_f32(x) for x in variances]
    a_center = _corner_to_center(anchor.reshape(-1, 4))
    off = loc_pred.reshape(B, N, 4)
    cx = off[..., 0] * v[0] * a_center[:, 2] + a_center[:, 0]
    cy = off[..., 1] * v[1] * a_center[:, 3] + a_center[:, 1]
    w = torch.exp(off[..., 2] * v[2]) * a_center[:, 2]
    h = torch.exp(off[..., 3] * v[3]) * a_center[:, 3]
    boxes = _center_to_corner(torch.stack([cx, cy, w, h], dim=-1))
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    # argmax over ALL classes; background winning -> invalid row.
    # foreground ids renumber past the background row (bg=0 -> id-1)
    best_all = cls_prob.argmax(dim=1)
    is_bg = torch.arange(C1, device=cls_prob.device)[None, :, None] \
        == background_id
    scores, best_fg = torch.where(is_bg, float("-inf"), cls_prob).max(dim=1)
    cls_id = torch.where(best_fg > background_id, best_fg - 1, best_fg) \
        .to(cls_prob.dtype)
    valid = (scores > threshold) & (best_all != background_id)
    rows = torch.cat([torch.where(valid, cls_id, -1.0)[..., None],
                      torch.where(valid, scores, -1.0)[..., None], boxes],
                     dim=-1)
    out = box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  force_suppress=force_suppress)
    # box_nms marks suppressed rows by score / id -1; normalize the id
    return torch.cat([torch.where(out[..., 1] > 0, out[..., 0], -1.0)
                      [..., None], out[..., 1:]], dim=-1)


def _bilinear_taps(v, size):
    """``_bilinear``'s clamped coordinate along one axis: the two source
    indices and the fraction of the far one."""
    v = v.clamp(0.0, size - 1.0)
    v0 = torch.floor(v).long()
    return v0, (v0 + 1).clamp(max=size - 1), v - v0


@register("ROIAlign", aliases=("roi_align", "_contrib_ROIAlign"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, max_samples=8):
    """RoIAlign (reference: roi_align.cc): the average of bilinear samples
    over each bin, no quantization. data: (B, C, H, W); rois: (R, 5)
    [batch_idx, x1, y1, x2, y2] in image coordinates. Sample coordinates
    are clamped into the map. ``sample_ratio <= 0`` is ADAPTIVE:
    ceil(bin size) samples a bin axis for each ROI, capped at
    ``max_samples`` (the JAX op's static grid with per-ROI validity
    weights). ``position_sensitive``: bin (i, j) reads its own channel
    group (R-FCN)."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    PH, PW = pooled_size
    adaptive = int(sample_ratio) <= 0
    S = int(max_samples) if adaptive else max(int(sample_ratio), 1)
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = rois.device
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale for k in range(1, 5))
    rw = (x2 - x1).clamp(min=1.0)
    rh = (y2 - y1).clamp(min=1.0)
    bin_h, bin_w = rh / PH, rw / PW
    iy = torch.arange(PH, dtype=torch.float32, device=dev)
    ix = torch.arange(PW, dtype=torch.float32, device=dev)
    j = torch.arange(S, dtype=torch.float32, device=dev)
    if adaptive:
        s_h = torch.ceil(bin_h).clamp(1.0, float(S))[:, None]    # (R, 1)
        s_w = torch.ceil(bin_w).clamp(1.0, float(S))[:, None]
    else:
        s_h = s_w = float(S)
    sy = (j + 0.5) / s_h            # fractions; only j < s_h are valid
    sx = (j + 0.5) / s_w
    wy = (j < s_h).to(torch.float32)
    wx = (j < s_w).to(torch.float32)
    if not adaptive:
        sy, sx, wy, wx = (t.expand(R, S) for t in (sy, sx, wy, wx))
    ys = y1[:, None, None] + (iy[None, :, None] + sy[:, None, :]) \
        * bin_h[:, None, None]                                  # (R, PH, S)
    xs = x1[:, None, None] + (ix[None, :, None] + sx[:, None, :]) \
        * bin_w[:, None, None]                                  # (R, PW, S)
    y0, y1_, ly = _bilinear_taps(ys.reshape(R, -1), H)
    x0, x1_, lx = _bilinear_taps(xs.reshape(R, -1), W)
    table = data.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base = (bidx * (H * W))[:, None, None]

    def at(yi, xi):                                   # (R, PH*S, PW*S, C)
        return table[base + yi[:, :, None] * W + xi[:, None, :]]

    ly, lx = ly[:, :, None, None], lx[:, None, :, None]
    samp = (at(y0, x0) * (1 - ly) * (1 - lx)
            + at(y0, x1_) * (1 - ly) * lx
            + at(y1_, x0) * ly * (1 - lx)
            + at(y1_, x1_) * ly * lx)
    samp = samp.reshape(R, PH, S, PW, S, C)
    w = wy[:, None, :, None, None, None] * wx[:, None, None, None, :, None]
    norm = (s_h * s_w).reshape(-1, 1, 1, 1) if adaptive else s_h * s_w
    out = ((samp * w).sum(dim=(2, 4)) / norm).permute(0, 3, 1, 2)
    if position_sensitive:
        # (R, C*PH*PW, PH, PW) -> (R, C, PH, PW): bin (i, j) reads group
        # i*PW + j of its channel
        Cp = out.shape[1] // (PH * PW)
        grouped = out.reshape(R, Cp, PH * PW, PH, PW)
        bin_idx = (torch.arange(PH, device=dev)[:, None] * PW
                   + torch.arange(PW, device=dev)[None, :])
        idx = bin_idx.expand(R, Cp, 1, PH, PW)
        out = torch.gather(grouped, 2, idx)[:, :, 0]
    return out


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """RoI max pooling with the reference's quantized bins (reference:
    roi_pooling.cc): corners rounded half to even, each bin's max as two
    separable masked maxes (rows, then columns); an empty bin is 0."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    PH, PW = pooled_size
    H, W = data.shape[2], data.shape[3]
    dev = rois.device
    feat = data[rois[:, 0].long()]                              # (R,C,H,W)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      for k in range(1, 5))
    rh = (y2 - y1 + 1).clamp(min=1.0)
    rw = (x2 - x1 + 1).clamp(min=1.0)
    bin_h, bin_w = rh / PH, rw / PW
    iy = torch.arange(PH, dtype=torch.float32, device=dev)
    ix = torch.arange(PW, dtype=torch.float32, device=dev)
    hs = torch.floor(y1[:, None] + iy * bin_h[:, None])         # (R, PH)
    he = torch.maximum(torch.ceil(y1[:, None] + (iy + 1) * bin_h[:, None]),
                       hs + 1)
    ws = torch.floor(x1[:, None] + ix * bin_w[:, None])
    we = torch.maximum(torch.ceil(x1[:, None] + (ix + 1) * bin_w[:, None]),
                       ws + 1)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    mask_y = (rows >= hs[..., None]) & (rows < he[..., None])   # (R, PH, H)
    mask_x = (cols >= ws[..., None]) & (cols < we[..., None])   # (R, PW, W)
    neg = float("-inf")
    rowmax = torch.where(mask_y[:, None, :, :, None], feat[:, :, None],
                         neg).amax(dim=3)                       # (R,C,PH,W)
    out = torch.where(mask_x[:, None, None], rowmax[:, :, :, None],
                      neg).amax(dim=4)                          # (R,C,PH,PW)
    return torch.where(torch.isfinite(out), out, 0.0)


@register("Proposal", aliases=("proposal", "_contrib_Proposal"))
def proposal(cls_prob, bbox_pred, im_info, scales=(4, 8, 16, 32),
             ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             feature_stride=16):
    """RPN proposal generation (reference: proposal.cc). cls_prob:
    (B, 2*A, H, W); bbox_pred: (B, 4*A, H, W); im_info: (B, 3)
    [height, width, scale]. Returns (B, post_top_n, 5)
    [batch_idx, x1, y1, x2, y2] (fixed shape; an invalid row's box is
    zero). Deltas are clipped to +-10 before ``exp``."""
    B, _, H, W = cls_prob.shape
    A = len(scales) * len(ratios)
    dev = cls_prob.device
    # base anchors centred on each stride cell (image coordinates), as the
    # JAX op's f32 table holds them
    base = []
    cs = feature_stride / 2.0
    for r in ratios:
        for s in scales:
            size = feature_stride * s
            w_half = size * (1.0 / r) ** 0.5 / 2.0
            h_half = size * (r ** 0.5) / 2.0
            base.append([_f32(cs - w_half), _f32(cs - h_half),
                         _f32(cs + w_half), _f32(cs + h_half)])
    shift_x = torch.arange(W, dtype=torch.float32, device=dev) \
        * feature_stride
    shift_y = torch.arange(H, dtype=torch.float32, device=dev) \
        * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    anchors = torch.stack([
        torch.stack([sx + b[0], sy + b[1], sx + b[2], sy + b[3]], dim=-1)
        for b in base], dim=2).reshape(-1, 4)                   # (H*W*A, 4)

    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(B, -1, 4)
    ac = _corner_to_center(anchors)
    cx = deltas[..., 0] * ac[:, 2] + ac[:, 0]
    cy = deltas[..., 1] * ac[:, 3] + ac[:, 1]
    w = torch.exp(deltas[..., 2].clamp(-10, 10)) * ac[:, 2]
    h = torch.exp(deltas[..., 3].clamp(-10, 10)) * ac[:, 3]
    boxes = _center_to_corner(torch.stack([cx, cy, w, h], dim=-1))
    x_hi = (im_info[:, 1] - 1)[:, None]
    y_hi = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack([
        torch.minimum(boxes[..., 0].clamp(min=0), x_hi),
        torch.minimum(boxes[..., 1].clamp(min=0), y_hi),
        torch.minimum(boxes[..., 2].clamp(min=0), x_hi),
        torch.minimum(boxes[..., 3].clamp(min=0), y_hi)], dim=-1)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    ok = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    scores = torch.where(ok, scores, -1.0)

    k = min(rpn_pre_nms_top_n, scores.shape[1])
    top_scores, idx = _stable_top(scores, k)
    top_boxes = _take(boxes, idx)
    keep, order = _nms(top_boxes, top_scores, torch.zeros_like(top_scores),
                       threshold, -1.0, -1, True)
    kept_scores = torch.where(keep, torch.gather(top_scores, 1, order), -1.0)
    kept_boxes = _take(top_boxes, order)
    k2 = min(rpn_post_nms_top_n, k)
    top2, idx2 = _stable_top(kept_scores, k2)
    final = _take(kept_boxes, idx2) * (top2 > 0)[..., None]
    pad = rpn_post_nms_top_n - k2
    if pad > 0:
        final = torch.cat([final, final.new_zeros(B, pad, 4)], dim=1)
    bidx = torch.arange(B, dtype=final.dtype, device=dev)[:, None, None] \
        .expand(B, final.shape[1], 1)
    return torch.cat([bidx, final], dim=-1)


# --------------------------------------------------------------------- #
# box codecs, matching, misc
# --------------------------------------------------------------------- #
@register("box_encode", aliases=("_contrib_box_encode",), num_outputs=2)
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD-style corner-box regression-target encoding. samples (B, N) in
    {+1, 0, -1}; matches (B, N) ref indices; anchors (B, N, 4) and refs
    (B, M, 4) corner boxes. Returns (targets (B, N, 4), masks (B, N, 4))."""
    M = refs.shape[1]
    m = matches.long()
    m = torch.where(m < 0, m + M, m).clamp(0, M - 1)   # take's wrap-around
    matched = _take(refs, m)

    def _cxywh(b):
        w = b[..., 2] - b[..., 0]
        h = b[..., 3] - b[..., 1]
        return b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w, h

    ax, ay, aw, ah = _cxywh(anchors)
    gx, gy, gw, gh = _cxywh(matched)
    means = [_f32(x) for x in means]
    stds = [_f32(x) for x in stds]
    aw_, ah_ = aw.clamp(min=1e-12), ah.clamp(min=1e-12)
    t = torch.stack([
        ((gx - ax) / aw_ - means[0]) / stds[0],
        ((gy - ay) / ah_ - means[1]) / stds[1],
        (torch.log((gw / aw_).clamp(min=1e-12)) - means[2]) / stds[2],
        (torch.log((gh / ah_).clamp(min=1e-12)) - means[3]) / stds[3]],
        dim=-1)
    mask = (samples > 0.5)[..., None]
    return torch.where(mask, t, 0.0), mask.to(anchors.dtype) * \
        torch.ones_like(t)


@register("box_decode", aliases=("_contrib_box_decode",))
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Invert box_encode: deltas (B, N, 4) + anchors (1|B, N, 4) -> corner
    boxes (B, N, 4)."""
    a = anchors
    if format == "corner":
        aw = a[..., 2] - a[..., 0]
        ah = a[..., 3] - a[..., 1]
        ax = a[..., 0] + 0.5 * aw
        ay = a[..., 1] + 0.5 * ah
    else:
        ax, ay, aw, ah = a.unbind(-1)
    ox = data[..., 0] * std0 * aw + ax
    oy = data[..., 1] * std1 * ah + ay
    dw, dh = data[..., 2] * std2, data[..., 3] * std3
    if clip > 0:
        dw = dw.clamp(max=clip)
        dh = dh.clamp(max=clip)
    ow = torch.exp(dw) * aw * 0.5
    oh = torch.exp(dh) * ah * 0.5
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


@register("bipartite_matching", aliases=("_contrib_bipartite_matching",),
          num_outputs=2)
def bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy bipartite matching over a (..., N, M) score matrix
    (reference bipartite_matching): min(N, M) (or topk) greedy picks, each
    the best entry of the rows and columns not matched yet. Returns (row
    -> column match or -1, column -> row match or -1)."""
    N, M = data.shape[-2], data.shape[-1]
    lead = data.shape[:-2]
    flat = data.reshape(-1, N, M)
    G = flat.shape[0]
    dev = data.device
    big = 1e30
    sgn = 1.0 if not is_ascend else -1.0
    K = min(N, M) if topk < 0 else min(topk, min(N, M))
    signed = sgn * flat
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    row_used = torch.zeros(G, N, dtype=torch.bool, device=dev)
    col_used = torch.zeros(G, M, dtype=torch.bool, device=dev)
    row_out = torch.full((G, N), -1, dtype=torch.long, device=dev)
    col_out = torch.full((G, M), -1, dtype=torch.long, device=dev)
    for _ in range(K):
        eff = torch.where(row_used[:, :, None] | col_used[:, None, :], -big,
                          signed).reshape(G, -1)
        idx = eff.argmax(dim=1)
        r, c = idx // M, idx % M
        # accept: score >= thresh (descending) / <= thresh (ascending),
        # both `eff >= sgn * thresh` on the sign-flipped matrix
        ok = torch.gather(eff, 1, idx[:, None])[:, 0] >= sgn * threshold
        hit_r = (rows[None] == r[:, None]) & ok[:, None]
        hit_c = (cols[None] == c[:, None]) & ok[:, None]
        row_out = torch.where(hit_r, c[:, None], row_out)
        col_out = torch.where(hit_c, r[:, None], col_out)
        row_used |= hit_r
        col_used |= hit_c
    return (row_out.reshape(lead + (N,)).to(data.dtype),
            col_out.reshape(lead + (M,)).to(data.dtype))


class _GradMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("gradientmultiplier", aliases=("_contrib_gradientmultiplier",))
def gradientmultiplier(data, scalar=1.0):
    """Identity forward, gradient scaled by ``scalar`` (reference
    gradient_multiplier_op.cc: the GAN / DANN gradient-reversal trick)."""
    return _GradMult.apply(data, float(scalar))


@register("group_adagrad_update", aliases=("_contrib_group_adagrad_update",),
          num_outputs=2)
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Row-wise AdaGrad (reference optimizer_op.cc GroupAdagrad: one
    accumulator per row; epsilon OUTSIDE the sqrt). ``history`` may be
    (N,) or the reference's keepdims (N, 1, ...) shape; the returned
    accumulator keeps the caller's shape."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    hist_shape = history.shape
    history = history.reshape(history.shape[0])
    red = tuple(range(1, g.dim()))
    mean_sq = torch.mean(torch.square(g), dim=red) if red else torch.square(g)
    new_hist = history + mean_sq
    denom = torch.sqrt(new_hist) + epsilon
    shape = (-1,) + (1,) * (g.dim() - 1)
    return (weight - lr * g / denom.reshape(shape),
            new_hist.reshape(hist_shape))


# --------------------------------------------------------------------- #
# deformable convolution v1 / v2
# --------------------------------------------------------------------- #
def _deform_conv_core(data, offset, weight, bias, kernel, stride, dilate,
                      pad, num_filter, num_group, num_deformable_group,
                      mask=None):
    """The deformed sampling grid as (K2, Ho, Wo) pixel coordinates plus
    the offsets, bilinear taps through ``_grid_sample_zero_pad``, and one
    contraction over (C_in / group, K2), in f32."""
    B, C, H, W = data.shape
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    Ho = (H + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    Wo = (W + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    K2 = kh * kw
    G = num_deformable_group
    dev = data.device

    def axis(n_out, s, p, k, d):
        return (torch.arange(k, device=dev)[:, None] * d
                + torch.arange(n_out, device=dev)[None, :] * s - p) \
            .to(torch.float32)                                   # (k, out)

    ay = axis(Ho, sh, ph, kh, dh)
    ax = axis(Wo, sw, pw, kw, dw)
    base_y = ay[:, None, :, None].expand(kh, kw, Ho, Wo).reshape(K2, Ho, Wo)
    base_x = ax[None, :, None, :].expand(kh, kw, Ho, Wo).reshape(K2, Ho, Wo)
    off = offset.reshape(B, G, K2, 2, Ho, Wo).to(torch.float32)
    if mask is not None:
        mk = mask.reshape(B, G, K2, Ho, Wo).to(torch.float32)
    feat = data.to(torch.float32)
    Cg = C // G
    groups = []
    for g in range(G):
        s = _grid_sample_zero_pad(feat[:, g * Cg:(g + 1) * Cg],
                                  base_y + off[:, g, :, 0],
                                  base_x + off[:, g, :, 1])
        if mask is not None:
            s = s * mk[:, g][:, None]
        groups.append(s)                                 # (B, Cg, K2, Ho, Wo)
    sampled = torch.cat(groups, dim=1)
    Og = num_filter // num_group
    Cng = C // num_group
    w = weight.reshape(num_group, Og, Cng, K2).to(torch.float32)
    x = sampled.reshape(B, num_group, Cng, K2, Ho, Wo)
    out = torch.einsum("bgckhw,gock->bgohw", x, w)
    out = out.reshape(B, num_filter, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.to(data.dtype)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register("DeformableConvolution",
          aliases=("_contrib_DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1,
                           num_deformable_group=1, no_bias=False):
    """Deformable convolution v1 (Dai et al. 2017). ``offset``
    (B, 2*K2*deform_groups, Ho, Wo) carries per-tap (dy, dx)."""
    return _deform_conv_core(data, offset, weight,
                             None if no_bias else bias, _pair(kernel),
                             _pair(stride), _pair(dilate), _pair(pad),
                             num_filter, num_group, num_deformable_group)


@register("ModulatedDeformableConvolution",
          aliases=("_contrib_ModulatedDeformableConvolution",))
def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     kernel=(3, 3), stride=(1, 1),
                                     dilate=(1, 1), pad=(0, 0),
                                     num_filter=0, num_group=1,
                                     num_deformable_group=1, no_bias=False):
    """Deformable convolution v2 (Zhu et al. 2019): adds a per-tap
    modulation ``mask`` (B, K2*deform_groups, Ho, Wo)."""
    return _deform_conv_core(data, offset, weight,
                             None if no_bias else bias, _pair(kernel),
                             _pair(stride), _pair(dilate), _pair(pad),
                             num_filter, num_group, num_deformable_group,
                             mask=mask)


# --------------------------------------------------------------------- #
# count sketch, Hawkes log-likelihood, Mask R-CNN mask targets
# --------------------------------------------------------------------- #
@register("count_sketch", aliases=("_contrib_count_sketch",))
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count-sketch projection (compact bilinear pooling): data (B, D) into
    (B, out_dim), out[b, h[d]] += s[d] * data[b, d] for the (D,) bucket
    indices ``h`` and +-1 signs ``s``; one ``index_add``."""
    out_dim = int(out_dim)
    if out_dim <= 0:
        raise MXNetError("count_sketch requires out_dim > 0")
    hh = h.reshape(-1).long()
    signed = data * s.reshape(-1).to(data.dtype)
    out = data.new_zeros(data.shape[:-1] + (out_dim,))
    return out.index_add(data.dim() - 1, hh, signed)


@register("hawkes_ll", aliases=("_contrib_hawkes_ll",), num_outputs=2)
def hawkes_ll(lda, alpha, beta, state, lags, marks, valid_length,
              max_time):
    """Log-likelihood of a marked multivariate Hawkes process with an
    exponential kernel (reference hawkes_ll.cc). lda / alpha / beta (K,):
    per-mark background rate, excitation and decay; state (B, K): the
    kernel state at the interval start; lags / marks (B, T): inter-arrival
    times and mark ids; valid_length (B,): events per sequence; max_time:
    the observation horizon. Returns (loglik (B,), new_state (B, K)); the
    recurrence over T is a Python loop."""
    B, T = lags.shape
    K = lda.shape[0]
    lda_ = lda.reshape(1, K)
    alpha_ = alpha.reshape(K)
    beta_ = beta.reshape(1, K)
    marks_i = marks.long()
    vl = valid_length.long()
    dev = lags.device
    ll = torch.zeros(B, dtype=torch.float32, device=dev)
    st = state.to(torch.float32)
    elapsed = torch.zeros(B, dtype=torch.float32, device=dev)
    for t in range(T):
        lag_t = lags[:, t].reshape(B, 1)
        mark_t = marks_i[:, t]
        valid = t < vl
        decay = torch.exp(-beta_ * lag_t)
        st_dec = st * decay
        intensity = lda_ + st_dec                                  # (B, K)
        lam = torch.gather(intensity, 1, mark_t[:, None])[:, 0]
        # compensator increment over this interval, all marks
        comp = torch.sum(lda_ * lag_t + (st / beta_) * (1.0 - decay), dim=1)
        ll = ll + torch.where(valid, torch.log(lam.clamp(min=1e-30)) - comp,
                              0.0)
        jump = (alpha_[mark_t] * beta_[0, mark_t])[:, None]
        add = torch.zeros(B, K, dtype=st.dtype, device=dev) \
            .scatter(1, mark_t[:, None], jump)
        st = torch.where(valid[:, None], st_dec + add, st)
        elapsed = elapsed + torch.where(valid, lag_t[:, 0], 0.0)
    # tail compensator from the last event to max_time
    rem = (max_time - elapsed).clamp(min=0.0).reshape(B, 1)
    decay = torch.exp(-beta_ * rem)
    ll = ll - torch.sum(lda_ * rem + (st / beta_) * (1.0 - decay), dim=1)
    return ll, st * decay


@register("mrcnn_mask_target", aliases=("_contrib_mrcnn_mask_target",),
          num_outputs=2)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets,
                      num_rois=None, num_classes=None, mask_size=(14, 14)):
    """Mask R-CNN training targets (reference mrcnn_mask_target.cu): each
    matched instance mask cropped to its ROI and resized to ``mask_size``
    by bilinear sampling; returns (mask_targets (B, N, C, mh, mw),
    mask_cls (B, N, C, mh, mw) one-hot weights). rois (B, N, 4) corner;
    gt_masks (B, M, IH, IW); matches (B, N); cls_targets (B, N)."""
    B, N = matches.shape[:2]
    M, IH, IW = gt_masks.shape[1:]
    mh, mw = (mask_size, mask_size) if isinstance(mask_size, int) \
        else tuple(mask_size)
    if not num_classes:
        raise MXNetError("mrcnn_mask_target requires num_classes (the "
                         "class count cannot be derived from a traced "
                         "cls_targets array)")
    C = int(num_classes)
    dev = rois.device
    picked = _take(gt_masks, matches.long())                 # (B, N, IH, IW)
    x1, y1, x2, y2 = rois.unbind(-1)
    ys = y1[..., None] + (y2 - y1)[..., None] * (
        torch.arange(mh, device=dev) + 0.5) / mh             # (B, N, mh)
    xs = x1[..., None] + (x2 - x1)[..., None] * (
        torch.arange(mw, device=dev) + 0.5) / mw
    grid_y = ys[..., :, None].expand(B, N, mh, mw).reshape(B * N, mh, mw)
    grid_x = xs[..., None, :].expand(B, N, mh, mw).reshape(B * N, mh, mw)
    cropped = _grid_sample_zero_pad(picked.reshape(B * N, 1, IH, IW),
                                    grid_y, grid_x).reshape(B, N, mh, mw)
    onehot = (cls_targets.long()[..., None]
              == torch.arange(C, device=dev)).to(cropped.dtype)  # (B, N, C)
    targets = cropped[:, :, None] * onehot[..., None, None]
    weights = onehot[..., None, None].expand(B, N, C, mh, mw)
    return targets, weights
