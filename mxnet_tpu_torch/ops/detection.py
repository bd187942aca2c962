"""Detection ops: MultiBoxPrior, MultiBoxTarget, MultiBoxDetection,
ROIPooling, Proposal (and MultiProposal), ROIAlign_v2, PSROIPooling,
DeformableConvolution and DeformablePSROIPooling.

Counterpart of ``mxnet_tpu/ops/detection.py``. Every op is plain torch over
the whole batch (and over every roi at once): no Python loop over samples
and no value read back to the host, so a walk of an SSD step enqueues the
whole op before anything waits on it. The loops that remain have static
trip counts: bipartite matching takes ``num_labels`` steps, the greedy NMS
``min(num_anchors, nms_topk)`` (Proposal's ``rpn_pre_nms_top_n``), so a
walk through them stays capturable.

What takes no gradient in the JAX package (matching, hard-negative mining,
the NMS walk, Proposal) runs without recording a tape; the loc targets'
encoding, the detections' scores and boxes and the pooled values are
recorded, so their gradients are the JAX package's autodiff. Ties break as
there: ``argmax`` and the stable sorts take the first index, and a max over
a bin splits its gradient evenly between equal values (``amax``, where
``max(dim)`` would route it all to one index).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .param import Bool, Float, FloatList, Int, Shape, Str
from .registry import alias_op, register_op

_F32 = torch.float32
# the greedy NMS precomputes its (rows x rows) overlap matrix up to this
# many entries; beyond it each step computes its own row
_NMS_PAIRWISE_MAX = 1 << 25


def _iou(boxes_a, boxes_b):
    """Pairwise IoU of corner boxes: (..., A, 4) x (..., B, 4) -> (..., A, B)."""
    ax1, ay1, ax2, ay2 = [boxes_a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [boxes_b[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _proposal_iou(boxes_a, boxes_b):
    """Proposal's pairwise IoU: +1-pixel extents (proposal.cc:236-268)."""
    ax1, ay1, ax2, ay2 = [boxes_a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [boxes_b[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0) \
        .clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0) \
        .clamp_min(0.0)
    inter = iw * ih
    area = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    areas = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / (area + areas - inter)


def _scalar(x, c):
    """``c`` as a 0-dim host tensor of ``x``'s dtype: an operand that a
    card's kernel takes by value. A card tensor made from host values
    (``new_tensor``) is a copy that waits for the card's queue, and that a
    CUDA graph cannot capture; no op here makes one."""
    return c if torch.is_tensor(c) else torch.tensor(c, dtype=x.dtype)


def _floor_at(x, c):
    """``max(x, c)`` whose gradient splits at a tie, as ``jnp.maximum``."""
    return torch.maximum(x, _scalar(x, c))


def _clip(x, lo, hi):
    """``jnp.clip``: max with ``lo``, then min with ``hi`` (tensors or
    numbers), ties' gradients split."""
    return torch.minimum(torch.maximum(x, _scalar(x, lo)), _scalar(x, hi))


def _table(values, device, dtype=torch.float32):
    """A small constant table made on ``device`` by fills (one per value),
    not by a copy from the host (see ``_scalar``)."""
    values = np.asarray(values)
    out = torch.empty(values.shape, dtype=dtype, device=device)
    for idx, v in np.ndenumerate(values):
        out[idx].fill_(v.item())
    return out


def _greedy_nms(ids, boxes, n_iter, overlaps, by_class):
    """The sequential greedy NMS over score-sorted rows, shared by
    MultiBoxDetection and Proposal. ``ids`` (B, N): a row's class, -1 when
    it is out; ``boxes`` (B, N, 4); ``overlaps(a, b)`` -> (B, I, J) bool.
    Step i, if row i is still in, takes out every later row that row i
    overlaps (of its class, with ``by_class``). A row's class never
    changes, so "still in" is one bool per row and a step is three
    kernels. The ``n_iter`` steps are a static count; the (n_iter x N)
    matrix of who takes out whom is computed once where it is small
    enough, else a row of it per step."""
    B, N = ids.shape
    col = torch.arange(N, device=ids.device)

    def takes_out(i, rows=None):
        if rows is not None:
            return rows[:, i]
        hit = overlaps(boxes[:, i:i + 1], boxes)[:, 0] & (col > i)
        return hit & (ids == ids[:, i:i + 1]) if by_class else hit

    rows = None
    if B * n_iter * N <= _NMS_PAIRWISE_MAX:
        rows = overlaps(boxes[:, :n_iter], boxes) \
            & (col[None, :] > col[:n_iter, None])
        if by_class:
            rows = rows & (ids[:, :n_iter, None] == ids[:, None, :])
    alive = ids >= 0
    for i in range(n_iter):
        alive = alive & ~(takes_out(i, rows) & alive[:, i:i + 1])
    return torch.where(alive, ids, -1.0)


# --- MultiBoxPrior ----------------------------------------------------------

def _multibox_prior(attrs, data):
    h, w = data.shape[2], data.shape[3]
    sizes = list(attrs.sizes)
    ratios = list(attrs.ratios)
    steps = list(attrs.steps)
    offs = list(attrs.offsets)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=_F32, device=dev) + offs[0]) * step_y
    cx = (torch.arange(w, dtype=_F32, device=dev) + offs[1]) * step_x
    # anchor (w/2, h/2) list: all sizes at ratio 1, then ratios[1:] at
    # sizes[0], in float64 and then rounded once (multibox_prior.cc)
    whs = [(s * h / w / 2.0, s / 2.0) for s in sizes]
    whs += [(sizes[0] * h / w * np.sqrt(r) / 2.0,
             sizes[0] / np.sqrt(r) / 2.0) for r in ratios[1:]]
    half = _table(np.asarray(whs, np.float32), dev)  # (A, 2)
    ctr = torch.stack(torch.meshgrid(cy, cx, indexing="ij"),
                      dim=-1).reshape(-1, 2)  # (hw, [cy, cx])
    cxy = ctr[:, None, :]
    out = torch.cat(
        [cxy[..., 1:2] - half[None, :, 0:1],   # xmin
         cxy[..., 0:1] - half[None, :, 1:2],   # ymin
         cxy[..., 1:2] + half[None, :, 0:1],   # xmax
         cxy[..., 0:1] + half[None, :, 1:2]],  # ymax
        dim=-1).reshape(1, -1, 4)
    if attrs.clip:
        out = out.clamp(0.0, 1.0)
    return out


def _prior_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    a = len(attrs.sizes) - 1 + len(attrs.ratios)
    return ([d], [(1, d[2] * d[3] * a, 4)], aux_shapes)


# --- MultiBoxTarget ---------------------------------------------------------

def _match(attrs, A, lab, cls_pred):
    """Matching and mining, no tape: (positive, negative, match_gt, valid),
    each (B, num_anchors) but ``valid`` (B, num_labels)."""
    B, L = lab.shape[0], lab.shape[1]
    NA = A.shape[0]
    dev = A.device
    # -1 rows end the list: everything after the first -1 is invalid
    valid = torch.cumprod((lab[:, :, 0] >= 0).to(torch.int32), dim=1) > 0
    overlaps = _iou(A, lab[:, :, 1:5]) * valid[:, None, :].to(_F32)
    flat_ov = overlaps.reshape(B, NA * L)

    # stage 1: greedy bipartite matching, one gt per step, over the
    # row-major flattened (anchors x labels) matrix (first maximum)
    match_iou = overlaps.new_full((B, NA), -1.0)
    match_gt = torch.full((B, NA), -1, dtype=torch.long, device=dev)
    a_matched = torch.zeros((B, NA), dtype=torch.bool, device=dev)
    g_matched = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for _ in range(L):
        blocked = (a_matched[:, :, None] | g_matched[:, None, :])
        masked = torch.where(blocked.reshape(B, NA * L), -1.0, flat_ov)
        flat = masked.argmax(dim=1, keepdim=True)
        bi = torch.div(flat, L, rounding_mode="floor")
        bg = flat % L
        biou = masked.gather(1, flat)
        ok = biou > 1e-6

        def put(x, at, val):
            return x.scatter(1, at, torch.where(ok, val, x.gather(1, at)))

        match_iou = put(match_iou, bi, biou)
        match_gt = put(match_gt, bi, bg)
        a_matched = put(a_matched, bi, torch.ones_like(ok))
        g_matched = put(g_matched, bg, torch.ones_like(ok))

    # stage 2: each anchor's best gt; above overlap_threshold -> positive
    best_gt = overlaps.argmax(dim=2)
    best_iou = overlaps.gather(2, best_gt[:, :, None])[:, :, 0]
    if attrs.overlap_threshold > 0:
        extra = (~a_matched) & (best_iou > attrs.overlap_threshold)
    else:
        extra = torch.zeros_like(a_matched)
    positive = a_matched | extra
    match_gt = torch.where(a_matched, match_gt, best_gt)
    match_iou = torch.where(a_matched, match_iou, best_iou)

    if attrs.negative_mining_ratio > 0:
        # hard negatives: the LOWEST background probability among the
        # candidates below the mining threshold (multibox_target.cc:230-237)
        # the count's product and the candidates' threshold compare in
        # float64, as the JAX package (jax_enable_x64) computes them
        num_pos = positive.sum(dim=1)
        num_neg = torch.minimum(
            (num_pos.to(torch.float64) * attrs.negative_mining_ratio)
            .to(torch.int32), (NA - num_pos).to(torch.int32))
        # the background probability in float64, rounded once to float32:
        # the ranking then does not hang on the last bit of a device's
        # float32 exp (with untrained weights many anchors' probabilities
        # lie an ulp apart, and the card's and the CPU's would rank them
        # differently)
        probs = torch.softmax(cls_pred.to(torch.float64), dim=1)[:, 0] \
            .to(_F32)
        cand = (~positive) & (match_iou.to(torch.float64)
                              < attrs.negative_mining_thresh)
        score = torch.where(cand, -probs, -float("inf"))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(NA, device=dev).expand(B, NA))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive
    return positive, negative, match_gt, valid


def _multibox_target(attrs, anchor, label, cls_pred):
    v = list(attrs.variances)
    A = anchor.reshape(-1, 4).to(_F32)
    lab = label.to(_F32)
    B, NA = lab.shape[0], A.shape[0]
    with torch.no_grad():
        positive, negative, match_gt, valid = _match(
            attrs, A.detach(), lab.detach(), cls_pred.detach().to(_F32))
        any_gt = valid.any(dim=1, keepdim=True)
        pos_f = positive.to(_F32)[:, :, None]
        loc_mask = torch.where(any_gt, pos_f.expand(B, NA, 4).reshape(B, -1),
                               0.0)
        rest = torch.where(negative, 0.0, attrs.ignore_label)
    # the gathers from the labels and the loc targets' encoding are
    # recorded: the anchors' and labels' gradients are the JAX package's
    # autodiff
    cls_id = lab[:, :, 0].gather(1, match_gt) + 1.0  # 0 is the background
    cls_target = torch.where(any_gt, torch.where(positive, cls_id, rest),
                             attrs.ignore_label)
    g = lab[:, :, 1:5].gather(1, match_gt[:, :, None].expand(B, NA, 4))
    aw = A[:, 2] - A[:, 0]
    ah = A[:, 3] - A[:, 1]
    ax = (A[:, 0] + A[:, 2]) * 0.5
    ay = (A[:, 1] + A[:, 3]) * 0.5
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gx = (g[..., 0] + g[..., 2]) * 0.5
    gy = (g[..., 1] + g[..., 3]) * 0.5
    lt = torch.stack([(gx - ax) / aw / v[0],
                      (gy - ay) / ah / v[1],
                      torch.log(_floor_at(gw / aw, 1e-12)) / v[2],
                      torch.log(_floor_at(gh / ah, 1e-12)) / v[3]], dim=-1)
    loc_target = torch.where(any_gt, (lt * pos_f).reshape(B, -1), 0.0)
    return loc_target, loc_mask, cls_target


def _target_infer(attrs, in_shapes, aux_shapes):
    a, _l, c = in_shapes
    if a is None or c is None:
        return None
    n, na = c[0], a[1]
    return (list(in_shapes), [(n, na * 4), (n, na * 4), (n, na)],
            aux_shapes)


# --- MultiBoxDetection ------------------------------------------------------

def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    if attrs.background_id != 0:
        raise MXNetError(
            "MultiBoxDetection supports background_id=0 only (the "
            "reference kernel hardcodes channel 0 as background too, "
            "multibox_detection.cc)")
    v = list(attrs.variances)
    A = anchor.reshape(-1, 4).to(_F32)
    NA = A.shape[0]
    cp = cls_prob.to(_F32)
    B = cp.shape[0]
    lp = loc_pred.to(_F32).reshape(B, NA, 4)
    score = cp[:, 1:].amax(dim=1)
    with torch.no_grad():
        cid = cp[:, 1:].argmax(dim=1).to(_F32)
        keep = score >= attrs.threshold
    # decode
    aw = A[:, 2] - A[:, 0]
    ah = A[:, 3] - A[:, 1]
    ax = (A[:, 0] + A[:, 2]) * 0.5
    ay = (A[:, 1] + A[:, 3]) * 0.5
    ox = lp[..., 0] * v[0] * aw + ax
    oy = lp[..., 1] * v[1] * ah + ay
    ow = torch.exp(lp[..., 2] * v[2]) * aw * 0.5
    oh = torch.exp(lp[..., 3] * v[3]) * ah * 0.5
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if attrs.clip:
        boxes = _clip(boxes, 0.0, 1.0)
    with torch.no_grad():
        # by score, descending, the rows under the threshold last
        order = torch.argsort(torch.where(keep, -score, float("inf")),
                              dim=1, stable=True)
        cid_s = torch.where(keep.gather(1, order), cid.gather(1, order), -1.0)
        if attrs.nms_topk > 0:
            cid_s = cid_s.masked_fill(
                torch.arange(NA, device=cid_s.device) >= attrs.nms_topk, -1.0)
    score_s = score.gather(1, order)
    boxes_s = boxes.gather(1, order[:, :, None].expand(B, NA, 4))
    if 0 < attrs.nms_threshold <= 1:
        # the rows past nms_topk are out already: the walk covers the first
        # n_iter rows only
        n_iter = (min(NA, attrs.nms_topk) if attrs.nms_topk > 0 else NA)
        thr = attrs.nms_threshold
        with torch.no_grad():
            head = _greedy_nms(cid_s[:, :n_iter], boxes_s[:, :n_iter].detach(),
                               n_iter, lambda a, b: _iou(a, b) >= thr,
                               by_class=not attrs.force_suppress)
            cid_s = torch.cat([head, cid_s[:, n_iter:]], dim=1)
    # invalid rows: [-1, 0, 0, 0, 0, 0] (the score too, as the JAX package)
    rest = torch.cat([score_s[:, :, None], boxes_s], dim=-1)
    return torch.cat([cid_s[:, :, None],
                      torch.where((cid_s < 0)[:, :, None], 0.0, rest)], dim=-1)


def _det_infer(attrs, in_shapes, aux_shapes):
    c = in_shapes[0]
    if c is None:
        return None
    return (list(in_shapes), [(c[0], c[2], 6)], aux_shapes)


# --- ROIPooling -------------------------------------------------------------

def _roi_pooling(attrs, data, rois):
    ph, pw = attrs.pooled_size
    scale = attrs.spatial_scale
    _n, _c, H, W = data.shape
    x = data.to(_F32)
    r = rois.to(_F32)
    dev = x.device
    bidx = r[:, 0].to(torch.long)
    x1 = torch.round(r[:, 1] * scale)
    y1 = torch.round(r[:, 2] * scale)
    x2 = torch.round(r[:, 3] * scale)
    y2 = torch.round(r[:, 4] * scale)
    rw = _floor_at(x2 - x1 + 1.0, 1.0)
    rh = _floor_at(y2 - y1 + 1.0, 1.0)
    bin_w = (rw / pw)[:, None]
    bin_h = (rh / ph)[:, None]
    hs = torch.arange(H, dtype=_F32, device=dev)
    ws = torch.arange(W, dtype=_F32, device=dev)
    # bin p covers [start_p, end_p) with floor/ceil per reference
    py = torch.arange(ph, dtype=_F32, device=dev)
    px = torch.arange(pw, dtype=_F32, device=dev)
    y_lo = torch.floor(py * bin_h + y1[:, None]).clamp(0, H)
    y_hi = torch.ceil((py + 1) * bin_h + y1[:, None]).clamp(0, H)
    x_lo = torch.floor(px * bin_w + x1[:, None]).clamp(0, W)
    x_hi = torch.ceil((px + 1) * bin_w + x1[:, None]).clamp(0, W)
    my = (hs >= y_lo[:, :, None]) & (hs < y_hi[:, :, None])   # (R, ph, H)
    mx = (ws >= x_lo[:, :, None]) & (ws < x_hi[:, :, None])   # (R, pw, W)
    img = x[bidx]                                             # (R, C, H, W)
    neg = -1e30
    # two masked maxima, over H and then over W (amax: tied maxima share
    # the gradient, as the JAX package's max does)
    t1 = torch.where(my[:, None, :, :, None], img[:, :, None], neg)
    t1 = t1.amax(dim=3)                                       # (R, C, ph, W)
    t2 = torch.where(mx[:, None, None], t1[:, :, :, None, :], neg)
    out = t2.amax(dim=4)                                      # (R, C, ph, pw)
    # empty bins (hi <= lo) give 0, the reference's is_empty
    empty = (y_hi <= y_lo)[:, :, None] | (x_hi <= x_lo)[:, None, :]
    return torch.where(empty[:, None], 0.0, out).to(data.dtype)


def _roi_infer(attrs, in_shapes, aux_shapes):
    d, r = in_shapes
    if d is None or r is None:
        return None
    ph, pw = attrs.pooled_size
    return ([d, r], [(r[0], d[1], ph, pw)], aux_shapes)


# --- Proposal ---------------------------------------------------------------

def _base_anchors(stride, ratios, scales):
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        size_r = np.floor(w * h / r)
        nw = np.floor(np.sqrt(size_r) + 0.5)
        nh = np.floor(nw * r + 0.5)
        for s in scales:
            ws, hs = nw * s, nh * s
            out.append([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                        cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])
    return np.asarray(out, np.float32)


def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """anchors -> delta decode + image clip -> min-size demotion -> top
    pre_nms -> NMS -> post_nms rois, cycling the survivors; no tape (the
    reference's backward writes zeros)."""
    ratios = list(attrs.ratios)
    scales = list(attrs.scales)
    stride = attrs.feature_stride
    n, two_a, H, W = cls_prob.shape
    A = two_a // 2
    if A != len(ratios) * len(scales):
        raise MXNetError(
            "cls_prob has %d anchors/position but scales x ratios gives %d"
            % (A, len(ratios) * len(scales)))
    dev = cls_prob.device
    f64 = torch.float64
    # float64 anchors, shift + base: the JAX package (jax_enable_x64)
    # decodes, clips and compares the boxes in float64 from them, and so
    # does this
    base = _table(_base_anchors(stride, ratios, scales), dev, f64)  # (A, 4)
    sx = (torch.arange(W, dtype=f64, device=dev) * stride)[None, :, None]
    sy = (torch.arange(H, dtype=f64, device=dev) * stride)[:, None, None]
    sx, sy = sx.expand(H, W, A), sy.expand(H, W, A)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    anchors = (shifts + base).reshape(-1, 4)
    N = anchors.shape[0]
    # pre_nms <= 0 disables the cap (proposal.cc:322); post is NOT clamped:
    # short supply cycles the kept proposals (proposal.cc:426)
    pre = N if attrs.rpn_pre_nms_top_n <= 0 \
        else min(attrs.rpn_pre_nms_top_n, N)
    post = attrs.rpn_post_nms_top_n
    pos_h = torch.arange(H, device=dev).repeat_interleave(W * A)
    pos_w = torch.arange(W, device=dev).repeat_interleave(A).repeat(H)
    with torch.no_grad():
        cp = cls_prob.to(_F32)
        fg = cp[:, A:].permute(0, 2, 3, 1).reshape(n, -1)
        deltas = bbox_pred.to(_F32).reshape(n, A, 4, H, W) \
            .permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
        info = im_info.to(_F32)
        im_h, im_w, im_scale = info[:, 0:1], info[:, 1:2], info[:, 2:3]
        if attrs.iou_loss:
            # IoU-loss mode: the deltas are corner offsets (IoUTransformInv)
            px1 = anchors[:, 0] + deltas[..., 0]
            py1 = anchors[:, 1] + deltas[..., 1]
            px2 = anchors[:, 2] + deltas[..., 2]
            py2 = anchors[:, 3] + deltas[..., 3]
        else:
            aw = anchors[:, 2] - anchors[:, 0] + 1.0
            ah = anchors[:, 3] - anchors[:, 1] + 1.0
            ax = anchors[:, 0] + 0.5 * (aw - 1.0)
            ay = anchors[:, 1] + 0.5 * (ah - 1.0)
            px = deltas[..., 0] * aw + ax
            py = deltas[..., 1] * ah + ay
            pw = torch.exp(deltas[..., 2]) * aw
            ph = torch.exp(deltas[..., 3]) * ah
            px1 = px - 0.5 * (pw - 1)
            py1 = py - 0.5 * (ph - 1)
            px2 = px + 0.5 * (pw - 1)
            py2 = py + 0.5 * (ph - 1)
        x1 = _clip(px1, 0.0, im_w - 1)
        y1 = _clip(py1, 0.0, im_h - 1)
        x2 = _clip(px2, 0.0, im_w - 1)
        y2 = _clip(py2, 0.0, im_h - 1)
        min_size = attrs.rpn_min_size * im_scale
        small = (x2 - x1 + 1 < min_size) | (y2 - y1 + 1 < min_size)
        # FilterBox grows a too-small box and demotes it to score -1 (a
        # last-resort fill); it does not drop it (proposal.cc:149-165)
        x1 = torch.where(small, x1 - min_size / 2, x1)
        y1 = torch.where(small, y1 - min_size / 2, y1)
        x2 = torch.where(small, x2 + min_size / 2, x2)
        y2 = torch.where(small, y2 + min_size / 2, y2)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        # anchors over the padded feature region are demoted too
        # (BBoxTransformInv's -1 marking, proposal.cc:373-377)
        padded = ((pos_h >= torch.floor(im_h / stride))
                  | (pos_w >= torch.floor(im_w / stride)))
        score = torch.where(small | padded, -1.0, fg)
        order = torch.argsort(-score, dim=1, stable=True)[:, :pre]
        b = boxes.gather(1, order[:, :, None].expand(n, pre, 4))
        s = score.gather(1, order)
        thr = attrs.threshold
        ids = _greedy_nms(s.new_zeros((n, pre)), b, pre,
                          lambda p, q: _proposal_iou(p, q) > thr,
                          by_class=False)
        keep = ids >= 0
        # the survivors in score order, cycled to fill the post slots
        # (proposal.cc:426-445 cur_keep[i % size])
        survivors = torch.argsort(-torch.where(keep, s, -float("inf")),
                                  dim=1, stable=True)
        n_keep = keep.sum(dim=1, keepdim=True).clamp_min(1)
        sel = survivors.gather(
            1, torch.arange(post, device=dev)[None, :] % n_keep)
        out_boxes = b.gather(1, sel[:, :, None].expand(n, post, 4))
        out_scores = s.gather(1, sel)
        batch_idx = torch.arange(n, dtype=_F32, device=dev) \
            .repeat_interleave(post)
        rois = torch.cat([batch_idx[:, None], out_boxes.reshape(-1, 4)],
                         dim=1).to(cls_prob.dtype)
        if attrs.output_score:
            return rois, out_scores.reshape(-1, 1).to(cls_prob.dtype)
        return rois


def _proposal_infer(attrs, in_shapes, aux_shapes):
    c = in_shapes[0]
    if c is None:
        return None
    n = c[0]
    post = attrs.rpn_post_nms_top_n
    a = c[1] // 2
    outs = [(n * post, 5)]
    if attrs.output_score:
        outs.append((n * post, 1))
    return ([c, (n, 4 * a, c[2], c[3]), (n, 3)], outs, aux_shapes)


# --- ROIAlign_v2 and PSROIPooling ---------------------------------------------

def _roi_align(attrs, data, rois):
    """Max over 4 bilinear samples per bin (the v2 kernel's 2x2 interior
    grid); the gradient goes through the winning sample's corners."""
    ph_n, pw_n = attrs.pooled_size
    scale = attrs.spatial_scale
    _n, C, H, W = data.shape
    x = data.to(_F32)
    r = rois.to(_F32)
    dev = x.device
    R = r.shape[0]
    bidx = r[:, 0].to(torch.long)
    x1, y1, x2, y2 = ((r[:, i] * scale)[:, None] for i in range(1, 5))
    bin_h = (y2 - y1) / ph_n
    bin_w = (x2 - x1) / pw_n
    ph = torch.arange(ph_n, dtype=_F32, device=dev)
    pw = torch.arange(pw_n, dtype=_F32, device=dev)
    hs = (ph * bin_h + y1).clamp(0, H - 1)
    he = ((ph + 1) * bin_h + y1).clamp(0, H - 1)
    ws = (pw * bin_w + x1).clamp(0, W - 1)
    we = ((pw + 1) * bin_w + x1).clamp(0, W - 1)
    # the interior 2-sample grid per dim (the kernel strides by
    # (end - start) / 3 from start + stride to end - stride)
    h_str = (he - hs) / 3.0
    w_str = (we - ws) / 3.0
    hh = torch.stack([hs + h_str, he - h_str], dim=-1)     # (R, PH, 2)
    ww = torch.stack([ws + w_str, we - w_str], dim=-1)     # (R, PW, 2)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    hl = torch.floor(hh).clamp(0, H - 1).to(torch.long)
    hu = torch.ceil(hh).clamp(0, H - 1).to(torch.long)
    wl = torch.floor(ww).clamp(0, W - 1).to(torch.long)
    wr = torch.ceil(ww).clamp(0, W - 1).to(torch.long)
    a = torch.where(hl == hu, 0.5, hh - hl)                # (R, PH, 2)
    b = torch.where(wl == wr, 0.5, ww - wl)                # (R, PW, 2)
    img = x.permute(0, 2, 3, 1)                            # (n, H, W, C)
    ri = bidx[:, None, None, None, None]

    def g(yi, xi):
        # -> (R, C, PH, PW, 2, 2)
        v = img[ri, yi[:, :, None, :, None], xi[:, None, :, None, :]]
        return v.permute(0, 5, 1, 2, 3, 4)

    tl, tr, bl, br = g(hl, wl), g(hl, wr), g(hu, wl), g(hu, wr)
    Aw = a[:, None, :, None, :, None]
    Bw = b[:, None, None, :, None, :]
    vals = ((1 - Aw) * (1 - Bw) * tl + (1 - Aw) * Bw * tr
            + Aw * (1 - Bw) * bl + Aw * Bw * br)
    out = vals.reshape(R, C, ph_n, pw_n, 4).amax(dim=-1)
    # padded roi rows (batch index < 0) give zeros and no gradient
    # (roi_align_v2-inl.h:76-82)
    invalid = (r[:, 0] < 0)[:, None, None, None]
    return torch.where(invalid | empty[:, None], 0.0, out).to(data.dtype)


def _psroi_pool(attrs, data, rois):
    p = attrs.pooled_size
    group = attrs.group_size or p
    od = attrs.output_dim
    scale = attrs.spatial_scale
    _n, _C, H, W = data.shape
    x = data.to(_F32)
    r = rois.to(_F32)
    dev = x.device
    hs_idx = torch.arange(H, dtype=_F32, device=dev)
    ws_idx = torch.arange(W, dtype=_F32, device=dev)
    # the position-sensitive channel map: bin (ph, pw) of output channel
    # ctop reads input channel (ctop * group + gh) * group + gw
    gh = torch.div(torch.arange(p, device=dev) * group, p,
                   rounding_mode="floor").clamp(0, group - 1)
    cmap = (torch.arange(od, device=dev)[:, None, None] * group
            + gh[None, :, None]) * group + gh[None, None, :]
    bidx = r[:, 0].to(torch.long)
    x1 = (torch.round(r[:, 1]) * scale)[:, None]
    y1 = (torch.round(r[:, 2]) * scale)[:, None]
    x2 = ((torch.round(r[:, 3]) + 1.0) * scale)[:, None]
    y2 = ((torch.round(r[:, 4]) + 1.0) * scale)[:, None]
    rw = _floor_at(x2 - x1, 0.1)
    rh = _floor_at(y2 - y1, 0.1)
    bh, bw = rh / p, rw / p
    phf = torch.arange(p, dtype=_F32, device=dev)
    h_lo = torch.floor(phf * bh + y1).clamp(0, H)
    h_hi = torch.ceil((phf + 1) * bh + y1).clamp(0, H)
    w_lo = torch.floor(phf * bw + x1).clamp(0, W)
    w_hi = torch.ceil((phf + 1) * bw + x1).clamp(0, W)
    my = ((hs_idx >= h_lo[:, :, None])
          & (hs_idx < h_hi[:, :, None])).to(_F32)          # (R, P, H)
    mxm = ((ws_idx >= w_lo[:, :, None])
           & (ws_idx < w_hi[:, :, None])).to(_F32)         # (R, P, W)
    img = x[bidx]                                          # (R, C, H, W)
    # separable: row sums, then bin sums, then the channel gather
    rows = torch.einsum("rchw,rph->rcpw", img, my)
    bins = torch.einsum("rcpw,rqw->rcpq", rows, mxm)       # (R, C, P, P)
    pi = torch.arange(p, device=dev)
    s = bins[:, cmap, pi[None, :, None], pi[None, None, :]]  # (R, od, P, P)
    area = (h_hi - h_lo)[:, :, None] * (w_hi - w_lo)[:, None, :]
    empty = (h_hi <= h_lo)[:, :, None] | (w_hi <= w_lo)[:, None, :]
    out = torch.where(empty[:, None], 0.0,
                      s / _floor_at(area, 1.0)[:, None])
    return out.to(data.dtype)


def _ps_infer(attrs, in_shapes, aux_shapes):
    d, r = in_shapes
    if d is None or r is None:
        return None
    p = attrs.pooled_size
    return ([d, r], [(r[0], attrs.output_dim, p, p)], aux_shapes)


# --- DeformableConvolution and DeformablePSROIPooling -------------------------

def _bilinear_nhw(img, ys, xs):
    """img (n, C, H, W); ys / xs (n, ...) float positions; returns
    (n, C, ...) with zeros outside (deformable_im2col_bilinear)."""
    n, C, H, W = img.shape
    flat = img.reshape(n, C, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)

    def corner(yi, xi, wgt):
        ok = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = yi.clamp(0, H - 1).to(torch.long)
        xc = xi.clamp(0, W - 1).to(torch.long)
        idx = (yc * W + xc).reshape(n, 1, -1).expand(n, C, -1)
        v = flat.gather(2, idx).reshape((n, C) + tuple(ys.shape[1:]))
        return v * (wgt * ok.to(_F32))[:, None]

    wy = ys - y0
    wx = xs - x0
    return (corner(y0, x0, (1 - wy) * (1 - wx))
            + corner(y0, x0 + 1, (1 - wy) * wx)
            + corner(y0 + 1, x0, wy * (1 - wx))
            + corner(y0 + 1, x0 + 1, wy * wx))


def _dc_geometry(attrs):
    if attrs.layout not in (None, "NCHW"):
        raise MXNetError("DeformableConvolution supports NCHW only (the "
                         "reference kernel is NCHW too); got layout=%r"
                         % (attrs.layout,))
    if len(attrs.kernel) != 2:
        raise MXNetError("DeformableConvolution is 2-d only")
    kh, kw = attrs.kernel
    sh, sw = attrs.stride or (1, 1)
    dh, dw = attrs.dilate or (1, 1)
    ph_, pw_ = attrs.pad or (0, 0)
    return kh, kw, sh, sw, dh, dw, ph_, pw_


def _deformable_convolution(attrs, data, offset, weight, *rest):
    kh, kw, sh, sw, dh, dw, ph_, pw_ = _dc_geometry(attrs)
    dg = attrs.num_deformable_group
    ng = attrs.num_group
    n, C, H, W = data.shape
    F = attrs.num_filter
    Ho = (H + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    K = kh * kw
    dev = data.device
    # the base tap positions of each output pixel
    hb = (torch.arange(Ho, device=dev) * sh - ph_)[:, None] \
        + (torch.arange(kh, device=dev) * dh)[None, :]        # (Ho, kh)
    wb = (torch.arange(Wo, device=dev) * sw - pw_)[:, None] \
        + (torch.arange(kw, device=dev) * dw)[None, :]        # (Wo, kw)
    base_y = hb[:, None, :, None].expand(Ho, Wo, kh, kw) \
        .permute(2, 3, 0, 1).reshape(K, Ho, Wo).to(_F32)
    base_x = wb[None, :, None, :].expand(Ho, Wo, kh, kw) \
        .permute(2, 3, 0, 1).reshape(K, Ho, Wo).to(_F32)
    # offset channels: [g, 2 * (i * kw + j)] = dy, + 1 = dx
    off = offset.reshape(n, dg, K, 2, Ho, Wo).to(_F32)
    Cg = C // dg
    x = data.to(_F32)
    cols = torch.cat([_bilinear_nhw(x[:, g * Cg:(g + 1) * Cg],
                                    base_y + off[:, g, :, 0],
                                    base_x + off[:, g, :, 1])
                      for g in range(dg)], dim=1)      # (n, C, K, Ho, Wo)
    w = weight.reshape(ng, F // ng, C // ng, K).to(_F32)
    cols = cols.reshape(n, ng, C // ng, K, Ho, Wo)
    out = torch.einsum("gfck,ngckhw->ngfhw", w, cols).reshape(n, F, Ho, Wo)
    if not attrs.no_bias:
        out = out + rest[0].reshape(1, -1, 1, 1)
    return out.to(data.dtype)


def _dc_infer(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    kh, kw, sh, sw, dh, dw, ph_, pw_ = _dc_geometry(attrs)
    Ho = (d[2] + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (d[3] + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    off = (d[0], 2 * kh * kw * attrs.num_deformable_group, Ho, Wo)
    wshape = (attrs.num_filter, d[1] // attrs.num_group, kh, kw)
    ins = [d, off, wshape]
    if not attrs.no_bias:
        ins.append((attrs.num_filter,))
    return (ins, [(d[0], attrs.num_filter, Ho, Wo)], aux_shapes)


def _deformable_psroi_pooling(attrs, data, rois, *rest):
    p = attrs.pooled_size
    part = attrs.part_size or p
    group = attrs.group_size
    od = attrs.output_dim
    spp = attrs.sample_per_part
    scale = attrs.spatial_scale
    no_trans = attrs.no_trans or not rest
    _n, C, H, W = data.shape
    if C != od * group * group:
        raise MXNetError(
            "DeformablePSROIPooling: data has %d channels, needs "
            "output_dim*group_size^2 = %d" % (C, od * group * group))
    if no_trans:
        ncls = 1
    else:
        ncls = rest[0].shape[1] // 2
        if ncls == 0 or od % ncls != 0:
            raise MXNetError(
                "DeformablePSROIPooling: output_dim (%d) must divide evenly "
                "into trans's %d offset classes" % (od, ncls))
    ch_each = od if no_trans else od // ncls
    x = data.to(_F32)
    r = rois.to(_F32)
    R = r.shape[0]
    dev = x.device
    # the kernel's integer maps per output position
    ph_i = torch.arange(p, device=dev)
    part_h = torch.div(ph_i * part, p, rounding_mode="floor") \
        .clamp_max(part - 1)
    gh = torch.div(ph_i * group, p, rounding_mode="floor").clamp(0, group - 1)
    ctop = torch.arange(od, device=dev)
    cls_map = torch.div(ctop, ch_each, rounding_mode="floor")  # (od,)
    chan = (ctop[:, None, None] * group + gh[None, :, None]) * group \
        + gh[None, None, :]                                    # (od, p, p)
    bidx = r[:, 0].to(torch.long)
    x1 = torch.round(r[:, 1]) * scale - 0.5
    y1 = torch.round(r[:, 2]) * scale - 0.5
    x2 = (torch.round(r[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(r[:, 4]) + 1.0) * scale - 0.5
    rw = _floor_at(x2 - x1, 0.1)[:, None, None, None]
    rh = _floor_at(y2 - y1, 0.1)[:, None, None, None]
    bh, bw = rh / p, rw / p
    sub_h, sub_w = bh / spp, bw / spp
    if no_trans:
        tx = ty = torch.zeros((R, 1, p, p), dtype=_F32, device=dev)
    else:
        trp = rest[0].reshape(R, ncls, 2, part, part).to(_F32)
        sel = trp[:, :, :, part_h[:, None], part_h[None, :]]   # (R, ncls, 2, p, p)
        tx = sel[:, :, 0] * attrs.trans_std
        ty = sel[:, :, 1] * attrs.trans_std
    phf = torch.arange(p, dtype=_F32, device=dev)
    hstart = (phf * bh[:, :, :, 0] + y1[:, None, None])[:, :, :, None] \
        + ty * rh                                         # (R, ncls, p, p)
    wstart = (phf * bw[:, :, :, 0] + x1[:, None, None])[:, :, None, :] \
        + tx * rw
    hs = hstart[:, cls_map]                                # (R, od, p, p)
    ws = wstart[:, cls_map]
    ri = bidx[:, None, None, None]
    total = torch.zeros((R, od, p, p), dtype=_F32, device=dev)
    cnt = torch.zeros((R, od, p, p), dtype=_F32, device=dev)
    for ih in range(spp):
        for iw in range(spp):
            hh = hs + ih * sub_h
            ww = ws + iw * sub_w
            valid = ((ww >= -0.5) & (ww <= W - 0.5)
                     & (hh >= -0.5) & (hh <= H - 0.5))
            hc = hh.clamp(0.0, H - 1.0)
            wc = ww.clamp(0.0, W - 1.0)
            y0 = torch.floor(hc)
            x0 = torch.floor(wc)
            dy = hc - y0
            dx = wc - x0
            y0i = y0.to(torch.long)
            x0i = x0.to(torch.long)
            y1i = (y0i + 1).clamp_max(H - 1)
            x1i = (x0i + 1).clamp_max(W - 1)
            val = ((1 - dy) * (1 - dx) * x[ri, chan, y0i, x0i]
                   + (1 - dy) * dx * x[ri, chan, y0i, x1i]
                   + dy * (1 - dx) * x[ri, chan, y1i, x0i]
                   + dy * dx * x[ri, chan, y1i, x1i])
            vf = valid.to(_F32)
            total = total + val * vf
            cnt = cnt + vf
    out = torch.where(cnt > 0, total / _floor_at(cnt, 1.0), 0.0)
    return out.to(data.dtype)


def _dps_infer(attrs, in_shapes, aux_shapes):
    r = in_shapes[1]
    if r is None:
        return None
    p = attrs.pooled_size
    return (list(in_shapes), [(r[0], attrs.output_dim, p, p)], aux_shapes)


def _register():
    register_op(
        "_contrib_MultiBoxPrior", _multibox_prior,
        params={"sizes": FloatList(default=(1.0,)),
                "ratios": FloatList(default=(1.0,)),
                "clip": Bool(default=False),
                "steps": FloatList(default=(-1.0, -1.0)),
                "offsets": FloatList(default=(0.5, 0.5))},
        num_inputs=1, infer_shape=_prior_infer,
        doc="SSD anchor generation over a feature map's grid (reference: "
            "src/operator/contrib/multibox_prior.cc)")
    register_op(
        "_contrib_MultiBoxTarget", _multibox_target,
        params={"overlap_threshold": Float(default=0.5),
                "ignore_label": Float(default=-1.0),
                "negative_mining_ratio": Float(default=-1.0),
                "negative_mining_thresh": Float(default=0.5),
                "minimum_negative_samples": Int(default=0),
                "variances": FloatList(default=(0.1, 0.1, 0.2, 0.2))},
        num_inputs=3, input_names=["anchor", "label", "cls_pred"],
        num_outputs=3, infer_shape=_target_infer,
        doc="SSD training-target assignment: greedy bipartite matching + "
            "per-anchor threshold matching + hard-negative mining "
            "(reference: src/operator/contrib/multibox_target.cc; "
            "minimum_negative_samples is accepted and ignored, as the "
            "reference CPU kernel never reads it)")
    register_op(
        "_contrib_MultiBoxDetection", _multibox_detection,
        params={"clip": Bool(default=True), "threshold": Float(default=0.01),
                "background_id": Int(default=0),
                "nms_threshold": Float(default=0.5),
                "force_suppress": Bool(default=False),
                "variances": FloatList(default=(0.1, 0.1, 0.2, 0.2)),
                "nms_topk": Int(default=-1)},
        num_inputs=3, input_names=["cls_prob", "loc_pred", "anchor"],
        infer_shape=_det_infer,
        doc="SSD decode + per-class NMS with fixed-shape padded output "
            "rows [id, score, xmin, ymin, xmax, ymax], -1 id = invalid "
            "(reference: src/operator/contrib/multibox_detection.cc)")
    register_op(
        "ROIPooling", _roi_pooling,
        params={"pooled_size": Shape(), "spatial_scale": Float()},
        num_inputs=2, input_names=["data", "rois"], infer_shape=_roi_infer,
        doc="max pooling over region-of-interest bins, rois = "
            "[batch_idx, x1, y1, x2, y2] (reference: "
            "src/operator/roi_pooling.cc)")
    register_op(
        "_contrib_Proposal", _proposal,
        params={"rpn_pre_nms_top_n": Int(default=6000),
                "rpn_post_nms_top_n": Int(default=300),
                "threshold": Float(default=0.7),
                "rpn_min_size": Int(default=16),
                "scales": FloatList(default=(4.0, 8.0, 16.0, 32.0)),
                "ratios": FloatList(default=(0.5, 1.0, 2.0)),
                "feature_stride": Int(default=16),
                "output_score": Bool(default=False),
                "iou_loss": Bool(default=False)},
        num_inputs=3, input_names=["cls_prob", "bbox_pred", "im_info"],
        num_outputs=lambda attrs: 2 if attrs.output_score else 1,
        infer_shape=_proposal_infer,
        doc="RPN proposal generation: anchors + delta decode + min-size "
            "filter + NMS, fixed-shape padded rois (reference: "
            "src/operator/contrib/proposal.cc)")
    # MultiProposal is the batched Proposal, and this Proposal is batched
    # already (reference: src/operator/contrib/multi_proposal.cc)
    alias_op("_contrib_Proposal", "_contrib_MultiProposal")
    register_op(
        "_contrib_ROIAlign_v2", _roi_align,
        params={"pooled_size": Shape(), "spatial_scale": Float()},
        num_inputs=2, input_names=["data", "rois"], infer_shape=_roi_infer,
        doc="ROI align (max over bilinear samples per bin) (reference: "
            "src/operator/contrib/roi_align_v2-inl.h)")
    register_op(
        "_contrib_PSROIPooling", _psroi_pool,
        params={"spatial_scale": Float(), "output_dim": Int(),
                "pooled_size": Int(), "group_size": Int(default=0)},
        num_inputs=2, input_names=["data", "rois"], infer_shape=_ps_infer,
        doc="position-sensitive ROI average pooling (R-FCN; reference: "
            "src/operator/contrib/psroi_pooling.cu)")
    register_op(
        "_contrib_DeformableConvolution", _deformable_convolution,
        params={"kernel": Shape(), "stride": Shape(default=()),
                "dilate": Shape(default=()), "pad": Shape(default=()),
                "num_filter": Int(), "num_group": Int(default=1),
                "num_deformable_group": Int(default=1),
                "workspace": Int(default=1024),
                "no_bias": Bool(default=False),
                "layout": Str(default=None)},
        num_inputs=lambda attrs: 3 if attrs.no_bias else 4,
        input_names=lambda attrs: ["data", "offset", "weight"]
        + ([] if attrs.no_bias else ["bias"]),
        infer_shape=_dc_infer,
        doc="convolution whose kernel taps sample at learned offset "
            "positions via zero-padded bilinear gather (reference: "
            "src/operator/contrib/deformable_convolution-inl.h)")
    register_op(
        "_contrib_DeformablePSROIPooling", _deformable_psroi_pooling,
        params={"spatial_scale": Float(), "output_dim": Int(),
                "group_size": Int(), "pooled_size": Int(),
                "part_size": Int(default=0),
                "sample_per_part": Int(default=1),
                "trans_std": Float(default=0.0),
                "no_trans": Bool(default=False)},
        num_inputs=lambda attrs: 2 if attrs.no_trans else 3,
        input_names=lambda attrs: ["data", "rois"]
        + ([] if attrs.no_trans else ["trans"]),
        infer_shape=_dps_infer,
        doc="position-sensitive ROI pooling with learned per-part (dx, dy) "
            "offsets scaled by trans_std and the roi size; "
            "sample_per_part^2 bilinear samples per bin, averaging only "
            "in-image samples (reference: src/operator/contrib/"
            "deformable_psroi_pooling.cu)")


_register()
