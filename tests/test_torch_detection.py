"""The port's detection layers (``bigdl_tpu_torch/nn/detection.py``) and
the dilated, shared and transposed convolutions against the JAX
package's, on the CPU, on the same numpy inputs made from seeds; weights
carried across by name (``test_torch_rnn.carry``).

Restates ``tests/test_detection.py`` but the Caffe weight import (it
waits for ``interop/``) and int8 SSD (it waits for ``nn/quantized.py``);
its SSD architecture case is in ``test_torch_detection_models.py``.

Tolerances.  Indices, labels and validity are equal.  float32 values are
within 1e-5 relative in norm (``near``) unless a test says why not;
PriorBox's boxes are equal bit for bit.  Detection rows whose inputs are
equal are equal: labels and kept slots, scores bit for bit (gathered,
never recomputed), boxes within 1e-6 of their largest coordinate (the
decode's ``exp`` and the products may round one ulp apart between XLA
and torch).  Forward and gradients of the convolutions rtol 1e-5, atol
1e-5 (their sums run in another order in each framework).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import detection as jdet
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import detection as pdet
from chip_smoke import nms_reference, ssd_rows_reference

from test_torch_rnn import (assert_run, carry, gen,  # noqa: F401
                            one_torch_thread, rnd, run_both)

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
BOX_REL = 1e-6


def near(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want),
                                                   1e-30)


def t(x):
    return torch.tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def boxes_of(rng, n, size=80.0, extent=40.0, lo=5.0):
    b = (rng.random((n, 4)) * size).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.random((n, 2)).astype(np.float32) * extent + lo
    return b


def np_iou(a, b):
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    aa = (a[2] - a[0]) * (a[3] - a[1])
    ab = (b[2] - b[0]) * (b[3] - b[1])
    return inter / (aa + ab - inter) if aa + ab - inter > 0 else 0.0


def np_nms(boxes, scores, thresh):
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        order = np.array([k for k in order[1:]
                          if np_iou(boxes[i], boxes[k]) <= thresh], int)
    return keep


# ---- box arithmetic ---------------------------------------------------------

def test_box_iou_matches_scalar_and_reference():
    rng = np.random.default_rng(0)
    a, b = boxes_of(rng, 6, 50, 50, 1), boxes_of(rng, 4, 50, 50, 1)
    got = pdet.box_iou(t(a), t(b)).numpy()
    for i in range(6):
        for k in range(4):
            assert abs(got[i, k] - np_iou(a[i], b[k])) < 1e-5
    np.testing.assert_array_equal(got, np.asarray(jdet.box_iou(a, b)))
    # leading dims: every row its own pairs
    batched = pdet.box_iou(t(np.stack([a, a[::-1]])), t(np.stack([b, b])))
    np.testing.assert_array_equal(batched[1].numpy(), got[::-1])


def test_bbox_transforms_match_reference():
    rng = np.random.default_rng(3)
    ex, gt = boxes_of(rng, 10, 50, 60, 4), boxes_of(rng, 10, 50, 60, 4)
    deltas = rng.standard_normal((10, 4)).astype(np.float32)
    deltas[0, 2] = 9.0   # beyond clip_h
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        near(pdet.bbox_transform_inv(t(ex), t(deltas), w),
             jdet.bbox_transform_inv(j(ex), j(deltas), w))
        near(pdet.bbox_encode(t(ex), t(gt), w),
             jdet.bbox_encode(j(ex), j(gt), w))
    # the round trip (test_detection.py's)
    back = pdet.bbox_transform_inv(t(ex), pdet.bbox_encode(t(ex), t(gt)))
    np.testing.assert_allclose(back.numpy(), gt, rtol=1e-4, atol=1e-3)


def test_clip_boxes():
    b = t([[-5.0, -5.0, 200.0, 90.0], [3.0, 120.0, 10.0, 130.0]])
    out = pdet.clip_boxes(b, 100, 150).numpy()
    np.testing.assert_allclose(out[0], [0, 0, 149, 90])
    np.testing.assert_array_equal(
        out, np.asarray(jdet.clip_boxes(j(b.numpy()), 100, 150)))
    # an image size on the device, as MaskRCNN passes it
    hw = torch.tensor([100.0, 150.0])
    np.testing.assert_array_equal(
        pdet.clip_boxes(b, hw[0], hw[1]).numpy(), out)


# ---- NMS --------------------------------------------------------------------

def test_nms_matches_numpy_reference():
    rng = np.random.default_rng(1)
    n = 40
    boxes = boxes_of(rng, n)
    scores = rng.random(n).astype(np.float32)
    idx, valid = pdet.nms(t(boxes), t(scores), 0.5, n)
    assert [int(i) for i, v in zip(idx, valid) if v] == \
        np_nms(boxes, scores, 0.5)


def test_nms_fixed_output_and_neg_inf_exclusion():
    boxes = t([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 10, 10]]).float()
    scores = torch.tensor([0.9, -math.inf, 0.8])
    idx, valid = pdet.nms(boxes, scores, 0.5, 5)
    assert idx.shape == (5,)
    assert [int(i) for i, v in zip(idx, valid) if v] == [0]


def _threshold_pair(x0, y0, s=1.0 / 32):
    """Two boxes whose IoU is 9/20 (= float32(0.45)) exactly."""
    return [[x0, y0, x0 + 14 * s, y0 + s], [x0 + 5 * s, y0, x0 + 20 * s,
                                            y0 + s]]


def nms_rows(case):
    """(boxes (R, n, 4), scores (R, n), threshold, max_output, pre_topk)."""
    rng = np.random.default_rng(11)
    if case == "plain":
        boxes = np.stack([boxes_of(rng, 30) for _ in range(3)])
        return boxes, rng.random((3, 30)).astype(np.float32), 0.5, 12, None
    if case == "pre_topk":
        boxes = np.stack([boxes_of(rng, 60) for _ in range(3)])
        return boxes, rng.random((3, 60)).astype(np.float32), 0.45, 20, 25
    if case == "ties":
        # scores from four values (ties everywhere), with the cut of
        # pre_topk and the suppressions among tied boxes
        boxes = np.stack([boxes_of(rng, 50, 40, 30) for _ in range(4)])
        scores = rng.integers(0, 4, (4, 50)).astype(np.float32) / 4
        return boxes, scores, 0.3, 16, 30
    if case == "all_neg_inf":
        boxes = np.stack([boxes_of(rng, 20) for _ in range(2)])
        scores = np.full((2, 20), -np.inf, np.float32)
        scores[1, :5] = rng.random(5)
        return boxes, scores, 0.5, 8, None
    if case == "n_below_max_output":
        boxes = np.stack([boxes_of(rng, 7) for _ in range(2)])
        return boxes, rng.random((2, 7)).astype(np.float32), 0.5, 12, None
    if case == "iou_at_threshold":
        # IoU exactly at the threshold keeps both (IoU > t suppresses)
        pairs = [_threshold_pair(float(k), 0.5) for k in range(3)]
        boxes = np.asarray([sum(pairs, [])] * 2, np.float32)
        scores = np.asarray([[0.9, 0.8, 0.7, 0.6, 0.5, 0.4],
                             [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
        return boxes, scores, 0.45, 6, None
    raise KeyError(case)


NMS_CASES = ["plain", "pre_topk", "ties", "all_neg_inf",
             "n_below_max_output", "iou_at_threshold"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_rows_match_reference(case):
    """One batched call equals the reference's nms on each row (jitted,
    vmapped) and the numpy copy of its loop: indices and validity."""
    boxes, scores, thresh, m, pre = nms_rows(case)
    idx, valid = pdet.nms(t(boxes), t(scores), thresh, m, pre)
    want_idx, want_valid = jax.jit(jax.vmap(
        lambda b, s: jdet.nms(b, s, thresh, m, pre)))(j(boxes), j(scores))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    for r in range(boxes.shape[0]):
        ref_idx, ref_valid = nms_reference(boxes[r], scores[r], thresh, m,
                                           pre)
        np.testing.assert_array_equal(valid[r].numpy(), ref_valid)
        np.testing.assert_array_equal(idx[r].numpy(), ref_idx)
    if case == "iou_at_threshold":
        assert valid.all()
    if case == "all_neg_inf":
        assert not valid[0].any() and valid[1].sum() >= 1


def test_nms_counts_its_launches_and_steps():
    boxes, scores, thresh, m, pre = nms_rows("pre_topk")
    launches, steps = pdet.nms.launches, pdet.nms.steps
    pdet.Nms(thresh, m)(t(scores), t(boxes))
    assert pdet.nms.launches - launches == 1
    assert pdet.nms.steps - steps == 60
    pdet.nms(t(boxes), t(scores), thresh, m, pre)
    assert pdet.nms.steps - steps == 60 + pre


def test_nms_pre_topk_matches_full():
    """tests/test_detection.py's regression: a pre-top-k cap does not
    change the result when the winners are inside it."""
    rng = np.random.RandomState(0)
    base = np.stack([np.linspace(0, 9, 10) * 30, np.zeros(10),
                     np.linspace(0, 9, 10) * 30 + 20,
                     np.full(10, 20.0)], 1).astype(np.float32)
    jitter = np.repeat(base, 3, axis=0) + rng.rand(30, 4).astype(np.float32)
    boxes = t(np.concatenate([base, jitter]))
    scores = t(np.concatenate([0.9 + 0.01 * rng.rand(10),
                               0.1 * rng.rand(30)]).astype(np.float32))
    idx_full, val_full = pdet.nms(boxes, scores, 0.5, 10)
    idx_cap, val_cap = pdet.nms(boxes, scores, 0.5, 10, pre_topk=15)
    np.testing.assert_array_equal(val_full.numpy(), val_cap.numpy())
    np.testing.assert_array_equal(idx_full[val_full].numpy(),
                                  idx_cap[val_cap].numpy())


# ---- RoiAlign, RoiPooling, anchors --------------------------------------------

def naive_roi_align(feat, roi, scale, sr, ph, pw, aligned=True):
    """tests/test_detection.py's per-sample loop (numpy)."""
    H, W, C = feat.shape
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = [r * scale - off for r in roi]
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = max(rw, 1.0), max(rh, 1.0)
    out = np.zeros((ph, pw, C), np.float32)
    for py in range(ph):
        for px in range(pw):
            acc = np.zeros(C, np.float32)
            for iy in range(sr):
                for ix in range(sr):
                    y = y1 + (py + (iy + .5) / sr) * rh / ph
                    x = x1 + (px + (ix + .5) / sr) * rw / pw
                    if y < -1 or y > H or x < -1 or x > W:
                        continue
                    y = min(max(y, 0), H - 1)
                    x = min(max(x, 0), W - 1)
                    y0, x0 = int(y), int(x)
                    y1c, x1c = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
                    ly, lx = y - y0, x - x0
                    acc += ((1 - ly) * (1 - lx) * feat[y0, x0]
                            + (1 - ly) * lx * feat[y0, x1c]
                            + ly * (1 - lx) * feat[y1c, x0]
                            + ly * lx * feat[y1c, x1c])
            out[py, px] = acc / (sr * sr)
    return out


def test_roi_align_matches_naive():
    feat = rnd(16, 20, 3, seed=2)
    rois = np.array([[4.0, 4.0, 60.0, 50.0], [0.0, 0.0, 16.0, 16.0]],
                    np.float32)
    got = pnn.RoiAlign(0.25, 2, 7, 7, aligned=True)((t(feat)[None],
                                                      t(rois))).numpy()
    for i, roi in enumerate(rois):
        np.testing.assert_allclose(got[i], naive_roi_align(
            feat, roi, 0.25, 2, 7, 7), rtol=1e-4, atol=1e-5)


ROIS_OFF_MAP = np.array([[4.0, 4.0, 60.0, 50.0], [0.0, 0.0, 16.0, 16.0],
                         [-20.0, -12.0, 30.0, 9.0],     # over the top left
                         [70.0, 50.0, 110.0, 90.0],     # past the far edge
                         [200.0, 200.0, 240.0, 260.0],  # wholly off the map
                         [10.0, 10.0, 10.5, 10.2]],     # under a pixel
                        np.float32)


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sr", [2, 0])
def test_roi_align_matches_reference(mode, aligned, sr):
    """sampling_ratio 0 takes 2 in both; the ``inside`` mask and the clip
    before ``floor`` at ROIs that leave the map."""
    feat = rnd(1, 16, 20, 5, seed=4)
    args = (0.25, sr, 4, 3, mode, aligned)
    got = pnn.RoiAlign(*args)((t(feat), t(ROIS_OFF_MAP)))
    want = jnn.RoiAlign(*args)((j(feat), j(ROIS_OFF_MAP)))
    near(got, want)
    assert not got[4].any()


def test_roi_pooling_matches_reference():
    feat = np.zeros((1, 8, 8, 1), np.float32)
    feat[0, 2, 3, 0] = 5.0
    out = pnn.RoiPooling(2, 2, 1.0)((t(feat), t([[0, 0, 0, 7, 7]]).float()))
    assert out.shape == (1, 2, 2, 1)
    assert out.max() == pytest.approx(5.0) and out[0, 0, 0, 0] == 5.0
    feat = rnd(2, 12, 10, 3, seed=5)
    rois = np.array([[0, 1.2, 2.0, 9.0, 7.5], [1, 0, 0, 4, 4],
                     [1, 6.0, 3.0, 30.0, 40.0], [0, 9, 11, 9, 11]],
                    np.float32)
    near(pnn.RoiPooling(3, 2, 0.8)((t(feat), t(rois))),
         jnn.RoiPooling(3, 2, 0.8)((j(feat), j(rois))))


def test_anchor_generation_matches_reference():
    a = pdet.Anchor(ratios=[0.5, 1.0, 2.0], scales=[8.0])
    assert a.anchor_num == 3
    r1 = a.base_anchors(16.0)[1]
    assert r1[2] - r1[0] + 1 == pytest.approx(128)
    assert (r1[0] + r1[2]) / 2 == pytest.approx(7.5)
    grid = a.generate(2, 3, 16.0, device="cpu").numpy()
    assert grid.shape == (2 * 3 * 3, 4)
    np.testing.assert_allclose(grid[3] - grid[0], [16, 0, 16, 0])
    for ratios, scales, hw, stride in (([0.5, 1.0, 2.0], [8.0, 16.0, 32.0],
                                        (5, 7), 16.0),
                                       ([0.5, 1.0, 2.0], [32 / 4], (9, 4),
                                        4.0)):
        ref = jdet.Anchor(ratios, scales)
        np.testing.assert_array_equal(
            pdet.Anchor(ratios, scales).generate(*hw, stride,
                                                 device="cpu").numpy(),
            np.asarray(ref.generate(*hw, stride)))
    assert a.generate(2, 3, 16.0, device="cpu") is \
        a.generate(2, 3, 16.0, device="cpu")


# ---- FPN, Pooler --------------------------------------------------------------

@pytest.mark.parametrize("top_blocks", [0, 1, 2])
def test_fpn_matches_reference(top_blocks):
    set_seed(0)
    kw = dict(in_channels_p6p7=32, out_channels_p6p7=6) \
        if top_blocks == 2 else {}
    ref = jnn.FPN([8, 16, 32], 4, top_blocks=top_blocks, **kw)
    port = carry(ref, pnn.FPN([8, 16, 32], 4, top_blocks=top_blocks, **kw,
                              **gen()))
    feats = [rnd(1, 15, 17, 8, seed=1), rnd(1, 8, 9, 16, seed=2),
             rnd(1, 4, 5, 32, seed=3)]
    got = port([t(f) for f in feats])
    want = ref([j(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        near(g.detach(), w)


def test_fpn_shapes_and_topdown():
    fpn = pnn.FPN([8, 16, 32], 4, top_blocks=1, **gen())
    feats = [torch.ones(1, 16, 16, 8), torch.ones(1, 8, 8, 16),
             torch.ones(1, 4, 4, 32)]
    assert [tuple(o.shape) for o in fpn(feats)] == [
        (1, 16, 16, 4), (1, 8, 8, 4), (1, 4, 4, 4), (1, 2, 2, 4)]


POOLER_ROIS = np.array([[0, 0, 40, 40], [0, 0, 120, 120], [5, 9, 70, 52],
                        [10, 3, 250, 310], [30, 30, 31, 31.5],
                        [-5, -5, 200, 30], [0, 0, 0, 0]], np.float32)


@pytest.mark.parametrize("scales", [[0.25, 0.125], [0.25, 0.125, 0.0625],
                                    [0.25, 0.0625]])
def test_pooler_matches_reference(scales):
    """Each ROI pooled from its level; ROIs held away from a level's
    edge (the next test takes one at it); with a level between the first
    and last that has no pooler ([0.25, 0.0625]), its ROIs give zeros."""
    feats = [rnd(1, 32 >> i, 36 >> i, 4, seed=i) for i in range(3)]
    ref, port = jnn.Pooler(3, scales, 2), pnn.Pooler(3, scales, 2)
    np.testing.assert_array_equal(port.level_of(t(POOLER_ROIS)).numpy(),
                                  np.asarray(ref.level_of(j(POOLER_ROIS))))
    near(port(([t(f) for f in feats], t(POOLER_ROIS))),
         ref(([j(f) for f in feats], j(POOLER_ROIS))))


def test_pooler_level_assignment():
    p = pnn.Pooler(3, [0.25, 0.125], 2)
    assert p.lvl_min == 2 and p.lvl_max == 3
    rois = t([[0, 0, 40, 40], [0, 0, 120, 120]]).float()
    assert p.level_of(rois).tolist() == [2, 3]
    out = p(([torch.ones(1, 32, 32, 4), torch.ones(1, 16, 16, 4)], rois))
    assert out.shape == (2, 3, 3, 4)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


def test_pooler_at_a_level_edge(record_property):
    """ROIs whose side puts sqrt(area) / 224 + 1e-6 within a few ulps of
    1 (the edge between levels 3 and 4): log2 may round either way in
    either package.  Each package's Pooler must pool each ROI from the
    level that package assigned it (one of the two), and where the two
    assign the same level their outputs agree; the levels each took are
    recorded."""
    scales = [0.25, 0.125, 0.0625, 0.03125]
    side = np.float32(224 * (1 - 1e-6))
    sides = side + np.arange(-6, 7, dtype=np.float32) * np.spacing(side)
    rois = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides,
                     sides], 1).astype(np.float32)
    ref, port = jnn.Pooler(2, scales, 2), pnn.Pooler(2, scales, 2)
    lv_port = port.level_of(t(rois)).numpy()
    lv_ref = np.asarray(ref.level_of(j(rois)))
    record_property("levels_port", lv_port.tolist())
    record_property("levels_reference", lv_ref.tolist())
    assert set(lv_port) <= {3, 4} and set(lv_ref) <= {3, 4}
    assert 3 in lv_port or 4 in lv_port
    feats = [rnd(1, 64 >> i, 64 >> i, 3, seed=20 + i) for i in range(4)]
    got = port(([t(f) for f in feats], t(rois))).numpy()
    want = np.asarray(ref(([j(f) for f in feats], j(rois))))
    for i, (lp, lr) in enumerate(zip(lv_port, lv_ref)):
        alone = pnn.RoiAlign(scales[lp - 2], 2, 2, 2)(
            (t(feats[lp - 2]), t(rois[i:i + 1]))).numpy()[0]
        np.testing.assert_allclose(got[i], alone, rtol=1e-6, atol=1e-7)
        if lp == lr:
            near(got[i], want[i])


# ---- RPN, Proposal, heads -----------------------------------------------------

def jit_call(module, *args):
    """``module(args)`` of a reference module under one jax.jit."""
    return jax.jit(lambda *a: module(a))(*args)


@pytest.mark.parametrize("min_size", [0, 6])
def test_region_proposal_matches_reference(min_size):
    """Five levels, the last with fewer anchors than pre_nms_topn (the
    batched NMS pads it), in eval mode."""
    set_seed(1)
    kw = dict(anchor_sizes=[16, 32, 64, 128, 256],
              aspect_ratios=[0.5, 1.0, 2.0],
              anchor_stride=[4, 8, 16, 32, 64], pre_nms_topn_test=40,
              post_nms_topn_test=24, nms_thresh=0.7, min_size=min_size)
    ref = jnn.RegionProposal(8, **kw).eval_mode()
    port = carry(ref, pnn.RegionProposal(8, **kw, **gen())).eval()
    with torch.no_grad():
        for m in (port.cls_logits, port.bbox_pred):
            m.weight.mul_(30.0)   # logits and deltas that spread
    ref.load_parameters(jax.tree_util.tree_map(
        jnp.asarray, {k: v for k, v in _params_of(port).items()}))
    feats = [rnd(1, 32 >> i, 32 >> i, 8, seed=i) for i in range(5)]
    info = np.array([128.0, 120.0], np.float32)
    with torch.no_grad():
        boxes, scores = port(([t(f) for f in feats], t(info)))
    want_b, want_s = jit_call(ref, [j(f) for f in feats], j(info))
    assert boxes.shape == (24, 4) and scores.shape == (24,)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()),
                                  np.isfinite(np.asarray(want_s)))
    near(boxes, want_b)
    near(np.nan_to_num(scores.numpy(), neginf=0),
         np.nan_to_num(np.asarray(want_s), neginf=0))
    b = boxes.numpy()
    assert b.min() >= 0 and b[:, 2].max() <= 119 and b[:, 3].max() <= 127


def _params_of(port):
    from bigdl_tpu_torch.interop import nest_jax_parameters
    return nest_jax_parameters({n: p.detach().numpy()
                                for n, p in port.named_parameters()})


def test_proposal_matches_reference():
    kw = dict(pre_nms_topn=60, post_nms_topn=10, ratios=[0.5, 1.0, 2.0],
              scales=[8.0], min_size=4.0)
    ref, port = jnn.Proposal(**kw).eval_mode(), pnn.Proposal(**kw).eval()
    a = port.anchor.anchor_num
    rng = np.random.default_rng(0)
    cls = np.asarray(jax.nn.softmax(rng.standard_normal(
        (1, 6, 6, 2 * a)).astype(np.float32), -1))
    bbox = (rng.standard_normal((1, 6, 6, 4 * a)) * 0.1).astype(np.float32)
    info = np.array([96.0, 96.0, 1.0, 1.0], np.float32)
    rois, scores = port((t(cls), t(bbox), t(info)))
    want_r, want_s = jit_call(ref, j(cls), j(bbox), j(info))
    assert rois.shape == (10, 5)
    np.testing.assert_array_equal(rois[:, 0].numpy(), 0.0)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_s))
    near(rois, want_r)


def _box_head(score_thresh=0.0, nms_thresh=0.5, max_per_image=8,
              scales=(0.25, 0.125), classes=5):
    set_seed(3)
    kw = dict(in_channels=4, resolution=3, scales=list(scales),
              sampling_ratio=2, score_thresh=score_thresh,
              nms_thresh=nms_thresh, max_per_image=max_per_image,
              output_size=16, num_classes=classes)
    ref = jnn.BoxHead(**kw).eval_mode()
    port = carry(ref, pnn.BoxHead(**kw, **gen())).eval()
    with torch.no_grad():   # class scores and boxes that spread
        port.cls_score.weight.mul_(100.0)
        port.bbox_pred.weight.mul_(200.0)
    ref.load_parameters(jax.tree_util.tree_map(jnp.asarray,
                                               _params_of(port)))
    return ref, port


def held_detections(got, want):
    """Box head outputs (boxes, labels, scores, valid) equal: validity
    and labels exactly, boxes and scores within 1e-5 in norm."""
    gb, gl, gs, gv = (x.detach().numpy() for x in got)
    wb, wl, ws, wv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    near(gb, wb)
    near(gs, ws)


def test_box_head_matches_reference_with_padded_proposals():
    ref, port = _box_head(score_thresh=0.05)
    feats = [rnd(1, 32, 32, 4, seed=1), rnd(1, 16, 16, 4, seed=2)]
    rng = np.random.default_rng(7)
    props = np.concatenate([boxes_of(rng, 12, 90, 40, 8),
                            np.zeros((4, 4), np.float32)])
    pvalid = np.array([True] * 12 + [False] * 4)
    info = np.array([128.0, 128.0], np.float32)
    got = port(([t(f) for f in feats], t(props), t(info), t(pvalid)))
    want = jit_call(ref, [j(f) for f in feats], j(props), j(info),
                    j(pvalid))
    held_detections(got, want)
    assert got[0].shape == (8, 4) and got[1].dtype == torch.int32
    lb = got[1][got[3]].numpy()
    assert ((lb >= 1) & (lb < 5)).all()
    unmasked = port(([t(f) for f in feats], t(props), t(info)))
    held_detections(unmasked, jit_call(ref, [j(f) for f in feats],
                                       j(props), j(info)))


def test_boxhead_masks_padded_proposals():
    """tests/test_detection.py's regression: padded proposal slots give
    no detection when their validity is passed."""
    head = pnn.BoxHead(in_channels=4, resolution=3, scales=[0.25],
                       sampling_ratio=2, score_thresh=0.01, nms_thresh=0.99,
                       max_per_image=16, output_size=8, num_classes=2,
                       **gen(5)).eval()
    feats = [t(np.random.RandomState(1).rand(1, 16, 16, 4)).float()]
    real = np.array([[0, 0, 15, 15], [20, 0, 35, 15], [40, 0, 55, 15],
                     [0, 20, 15, 35]], np.float32)
    props = t(np.concatenate([real, np.zeros((4, 4), np.float32)]))
    info = torch.tensor([64.0, 64.0])
    pvalid = torch.tensor([True] * 4 + [False] * 4)
    valid_masked = head((feats, props, info, pvalid))[3]
    valid_unmasked = head((feats, props, info))[3]
    assert int(valid_masked.sum()) <= 4
    assert int(valid_unmasked.sum()) > int(valid_masked.sum())


@pytest.mark.parametrize("dilation,use_gn", [(1, False), (2, True)])
def test_mask_head_matches_reference(dilation, use_gn):
    set_seed(4)
    kw = dict(in_channels=4, resolution=4, scales=[0.25, 0.125],
              sampling_ratio=2, layers=[8, 8], dilation=dilation,
              num_classes=3, use_gn=use_gn)
    ref = jnn.MaskHead(**kw)
    port = carry(ref, pnn.MaskHead(**kw, **gen()))
    feats = [rnd(1, 16, 16, 4, seed=3), rnd(1, 8, 8, 4, seed=4)]
    boxes = np.array([[0, 0, 20, 20], [8, 8, 40, 40], [3, 1, 60, 50]],
                     np.float32)
    labels = np.array([1, 2, 0], np.int32)
    masks, logits = port(([t(f) for f in feats], t(boxes), t(labels)))
    want_m, want_l = jit_call(ref, [j(f) for f in feats], j(boxes),
                              j(labels))
    assert masks.shape == (3, 8, 8) and logits.shape == (3, 3, 8, 8)
    near(masks.detach(), want_m)
    near(logits.detach(), want_l)
    m = masks.detach().numpy()
    assert (m >= 0).all() and (m <= 1).all()


# ---- SSD: PriorBox, DetectionOutputSSD; DetectionOutputFrcnn ------------------

def test_prior_box_values():
    pb = pnn.PriorBox(min_sizes=[30.0], max_sizes=[60.0],
                      aspect_ratios=[2.0], is_flip=True, is_clip=False,
                      variances=[0.1, 0.1, 0.2, 0.2], img_size=300,
                      step=100.0)
    assert pb.num_priors == 4
    out = pb(torch.zeros(1, 3, 3, 2)).numpy()
    assert out.shape == (2, 3 * 3 * 4 * 4)
    np.testing.assert_allclose(out[0].reshape(-1, 4)[0],
                               [35 / 300, 35 / 300, 65 / 300, 65 / 300],
                               rtol=1e-5)
    np.testing.assert_allclose(out[1].reshape(-1, 4)[0],
                               [0.1, 0.1, 0.2, 0.2], rtol=1e-6)


@pytest.mark.parametrize("layer", range(6))
def test_prior_box_bit_for_bit(layer):
    """SSD-300's six PriorBoxes at their maps (38 ... 1), and a clipped
    one with one variance: equal to the reference's bit for bit, built
    once per map shape."""
    from bigdl_tpu_torch.models.ssd import _SSD300_PRIORS
    mn, mx, ars, step, _ = _SSD300_PRIORS[layer]
    size = (38, 19, 10, 5, 3, 1)[layer]
    kw = dict(min_sizes=[mn], max_sizes=[mx], aspect_ratios=list(ars),
              is_flip=True, is_clip=layer == 0,
              variances=[0.1] if layer == 0 else [0.1, 0.1, 0.2, 0.2],
              offset=0.5, img_size=300, step=step)
    feat = torch.zeros(1, size, size, 2)
    port = pnn.PriorBox(**kw)
    got = port(feat)
    want = np.asarray(jnn.PriorBox(**kw)(jnp.zeros((1, size, size, 2))))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert port(feat) is got


def _ssd_inputs(b=3, n_priors=50, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    pri = boxes_of(rng, n_priors, 0.7, 0.25, 0.02)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (n_priors, 1))
    prior = np.stack([pri.ravel(), var.ravel()])
    loc = (rng.standard_normal((b, n_priors * 4)) * 0.5).astype(np.float32)
    conf = np.asarray(jax.nn.softmax(
        rng.standard_normal((b, n_priors, classes)).astype(np.float32) * 2,
        -1)).reshape(b, -1)
    return loc, conf, prior


@pytest.mark.parametrize("kw", [
    dict(n_classes=4, nms_thresh=0.45, nms_topk=20, keep_top_k=30,
         conf_thresh=0.1),
    dict(n_classes=4, nms_thresh=0.3, nms_topk=80, keep_top_k=200,
         conf_thresh=0.01),
    dict(n_classes=4, bg_label=2, nms_thresh=0.5, nms_topk=30,
         keep_top_k=16, conf_thresh=0.2, variance_encoded_in_target=True),
], ids=["capped", "padded_rows", "bg_2_encoded"])
def test_detection_output_ssd_batched_matches_reference(kw):
    """A batch of three images in one call against the reference's vmap
    and the numpy copy of its per-image loop."""
    loc, conf, prior = _ssd_inputs()
    port = pnn.DetectionOutputSSD(**kw)
    got = port((t(loc), t(conf), t(prior))).numpy()
    want = np.asarray(jit_call(jnn.DetectionOutputSSD(**kw), j(loc),
                               j(conf), j(prior)))
    assert got.shape == (3, kw["keep_top_k"], 6)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=BOX_REL)
    boxes = port.decode(t(loc), t(prior)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], ssd_rows_reference(boxes[i], conf[i].reshape(50, 4),
                                       port))


def test_detection_output_ssd():
    """tests/test_detection.py's two-prior case."""
    priors = np.array([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.9, 0.9]],
                      np.float32)
    prior = t(np.stack([priors.ravel(), np.full(8, 0.1, np.float32)]))
    conf = torch.tensor([[0.05, 0.9, 0.05, 0.1, 0.1, 0.8]])
    det = pnn.DetectionOutputSSD(n_classes=3, nms_thresh=0.45,
                                 keep_top_k=4, conf_thresh=0.1)
    rows = det((torch.zeros(1, 8), conf, prior)).numpy()[0]
    assert rows.shape == (4, 6)
    assert rows[0][0] == 1 and rows[0][1] == pytest.approx(0.9, abs=1e-5)
    np.testing.assert_allclose(rows[0][2:], priors[0], atol=1e-5)
    assert rows[1][0] == 2 and rows[1][1] == pytest.approx(0.8, abs=1e-5)
    np.testing.assert_allclose(rows[1][2:], priors[1], atol=1e-5)


def test_ssd_detection_output_map():
    """tests/test_detection.py's planted boxes: recovered, VOC mAP 1.0."""
    from bigdl_tpu_torch.optim import MeanAveragePrecisionObjectDetection
    from chip_smoke import planted_ssd_case
    loc, conf, prior, det, gts = planted_ssd_case("cpu")
    out = det((loc, conf, prior)).numpy()[0]
    kept = out[out[:, 1] > 0]
    assert kept.shape[0] == 2
    m = MeanAveragePrecisionObjectDetection(classes=2, iou_thresh=0.5)
    assert m.evaluate([(kept[:, 0].astype(int), kept[:, 1], kept[:, 2:6])],
                      gts) == 1.0


def test_detection_output_frcnn_matches_reference():
    rng = np.random.default_rng(9)
    n, c = 24, 4
    rois = np.concatenate([np.zeros((n, 1), np.float32),
                           boxes_of(rng, n, 60, 30, 4)], 1)
    cls = np.asarray(jax.nn.softmax(rng.standard_normal((n, c)) * 3, -1),
                     np.float32)
    bbox = (rng.standard_normal((n, 4 * c)) * 0.2).astype(np.float32)
    info = np.array([80.0, 90.0], np.float32)
    kw = dict(n_classes=c, nms_thresh=0.3, max_per_image=10, thresh=0.05)
    got = pnn.DetectionOutputFrcnn(**kw)((t(info), t(cls), t(bbox),
                                          t(rois))).numpy()
    want = np.asarray(jit_call(jnn.DetectionOutputFrcnn(**kw), j(info),
                               j(cls), j(bbox), j(rois)))
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    near(got[:, 2:], want[:, 2:])


# ---- criteria -----------------------------------------------------------------

def test_smooth_l1_with_weights():
    crit = pnn.SmoothL1CriterionWithWeights(sigma=1.0, num=2)
    got = float(crit(torch.tensor([0.0, 2.0]), torch.tensor([0.25, 0.0])))
    assert got == pytest.approx((0.03125 + 1.5) / 2)
    x, y = rnd(3, 8, seed=1), rnd(3, 8, seed=2)
    w_in, w_out = np.abs(rnd(3, 8, seed=3)), np.abs(rnd(3, 8, seed=4))
    for sigma, num in ((3.0, 0), (0.5, 5)):
        port = pnn.SmoothL1CriterionWithWeights(sigma, num)
        ref = jnn.SmoothL1CriterionWithWeights(sigma, num)
        xt = t(x).requires_grad_(True)
        loss = port(xt, (t(y), t(w_in), t(w_out)))
        loss.backward()
        want, vjp = jax.vjp(lambda a: ref(a, (j(y), j(w_in), j(w_out))),
                            j(x))
        near(loss.detach(), want)
        near(xt.grad, vjp(jnp.ones(()))[0])


@pytest.mark.parametrize("mode", ["VALID", "FULL", "BATCH_SIZE", "NONE"])
@pytest.mark.parametrize("ignore", [None, 2])
def test_softmax_with_criterion_matches_reference(mode, ignore):
    logits2 = np.array([[2.0, 1.0, 0.0], [0.0, 3.0, 0.0]], np.float32)
    target2 = np.array([1.0, 2.0], np.float32)
    want = -float(jnp.mean(jax.nn.log_softmax(logits2, -1)[
        jnp.arange(2), jnp.asarray([0, 1])]))
    assert float(pnn.SoftmaxWithCriterion()(t(logits2), t(target2))) == \
        pytest.approx(want, rel=1e-5)
    x = rnd(2, 4, 3, 5, seed=6)                       # (B, C, H, W)
    y = np.random.default_rng(6).integers(1, 5, (2, 3, 5)).astype(
        np.float32)
    port = pnn.SoftmaxWithCriterion(ignore, mode)
    ref = jnn.SoftmaxWithCriterion(ignore, mode)
    for xs, ys in ((x, y), (x[:, :, 0, 0], y[:, 0, 0])):
        xt = t(xs).requires_grad_(True)
        loss = port(xt, t(ys))
        loss.backward()
        want, vjp = jax.vjp(lambda a: ref(a, j(ys)), j(xs))
        near(loss.detach(), want)
        near(xt.grad, vjp(jnp.ones(()))[0])


# ---- the convolutions -----------------------------------------------------------

CONVS = {
    "dilated": lambda m, g: m.SpatialDilatedConvolution(
        5, 6, 3, 3, 1, 1, 2, 2, 2, 2, **g),
    "dilated_strided_asym": lambda m, g: m.SpatialDilatedConvolution(
        5, 6, 3, 2, 2, 1, 1, 0, 3, 2, **g),
    "dilated_same": lambda m, g: m.SpatialDilatedConvolution(
        5, 6, 3, 3, 2, 2, -1, -1, 2, 2, **g),
    "dilated_nchw": lambda m, g: m.SpatialDilatedConvolution(
        5, 6, 3, 3, 1, 1, 1, 1, 2, 2, data_format="NCHW", **g),
    "full_k2_s2": lambda m, g: m.SpatialFullConvolution(
        4, 6, 2, 2, 2, 2, **g),
    "full_k3_s2_pad1_adj1": lambda m, g: m.SpatialFullConvolution(
        4, 6, 3, 3, 2, 2, 1, 1, 1, 1, **g),
    "full_groups2_k3_s2_adj1": lambda m, g: m.SpatialFullConvolution(
        4, 6, 3, 3, 2, 2, 1, 1, 1, 1, n_group=2, **g),
    "full_groups2_k5x3_s2x1_adj0": lambda m, g: m.SpatialFullConvolution(
        4, 6, 3, 5, 1, 2, 1, 2, 0, 0, n_group=2, **g),
    "full_no_bias_nchw": lambda m, g: m.SpatialFullConvolution(
        4, 6, 3, 3, 2, 2, 0, 0, 1, 0, no_bias=True, data_format="NCHW",
        **g),
    "share": lambda m, g: m.SpatialShareConvolution(
        5, 6, 3, 3, 1, 1, 1, 1, **g),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_reference(name):
    """Forward, the input's gradient and the weight's and bias's,
    through one random cotangent (jax.vjp against autograd)."""
    set_seed(2)
    ref = CONVS[name](jnn, {})
    port = carry(ref, CONVS[name](pnn, gen()))
    cin = 4 if name.startswith("full") else 5
    shape = (2, cin, 7, 6) if name.endswith("nchw") else (2, 7, 6, cin)
    want, got = run_both(ref, port, [rnd(*shape, seed=3)])
    assert_run(want, got, out=CONV_TOL, grad=CONV_TOL)


def test_full_convolution_is_not_its_unflipped_kernel():
    """The transposed convolution against the reference's definition
    written out: the input dilated by the stride, padded k - 1 - p and
    k - 1 - p + adj, and convolved with the spatially flipped kernel;
    the same product over the unflipped kernel differs."""
    import torch.nn.functional as F
    conv = pnn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1, 1, 1,
                                      n_group=2, **gen(8))
    x = t(rnd(2, 5, 4, 4, seed=9))
    got = conv(x).detach()

    def lhs_dilated(w):
        nchw = x.permute(0, 3, 1, 2)
        d = torch.zeros(2, 4, 9, 7)
        d[:, :, ::2, ::2] = nchw
        d = F.pad(d, (1, 2, 1, 2))
        y = F.conv2d(d, w.permute(3, 2, 0, 1), conv.bias, groups=2)
        return y.permute(0, 2, 3, 1).detach()
    np.testing.assert_allclose(got.numpy(), lhs_dilated(
        torch.flip(conv.weight, (0, 1))).numpy(), rtol=1e-5, atol=1e-6)
    assert not np.allclose(got.numpy(), lhs_dilated(conv.weight).numpy(),
                           atol=1e-3)


def test_detection_module_exports_every_reference_name():
    import bigdl_tpu.nn.conv as jconv
    assert set(jdet.__all__) == set(pdet.__all__)
    for name in jdet.__all__ + ["SpatialDilatedConvolution",
                                "SpatialFullConvolution",
                                "SpatialShareConvolution"]:
        assert hasattr(pnn, name), name
    assert {"SpatialDilatedConvolution", "SpatialFullConvolution",
            "SpatialShareConvolution"} <= set(jconv.__all__)
