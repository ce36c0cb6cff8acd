"""The port's detectors (``models/ssd.py``, ``models/maskrcnn.py``) and the
rest of ``optim/validation.py`` against the JAX package's, on the CPU.

The reference models are built with their random draws stubbed to zeros
and take the port's weights, which the strict carry back
(``load_jax_parameters`` / ``load_jax_buffers``: every name and shape)
then loads into the port: a full-model output match, so the carry is
checked by what it computes and not by names alone.  Each reference
forward runs once per file under one ``jax.jit`` (the parameters as
arguments), in a module-scoped fixture the tests read: eagerly the SSD
forward took 24.5 s and Mask R-CNN's 62.6 s, jitted 3.4 s and 6.9 s.

Restates ``tests/test_detection.py``'s SSD architecture case (slow
there) and ``tests/test_maskrcnn_map.py``'s metric cases and
``test_maskrcnn_forward_shapes`` (slow there).  The reference has no
direct test of ``HitRatio`` / ``NDCG`` (its suite reaches them through
NCF paths): they are held against the reference's methods on seeded
scores with ties.

Tolerances.  SSD's loc and conf within 1e-5 relative in norm (23
convolutions summed in another order); its priors bit for bit.  The
detection rows of the two frameworks come from inputs that differ by
that rounding, so they are held by ``chip_smoke.detections_held``: rows
equal (label, score within 1e-5, box within 1e-5 of the largest
coordinate) except rows whose decision lay within 1e-5 of a threshold,
a cut or a neighbour, and none without such a reason.  The same rows
from the reference's own loc, conf and priors are equal (labels, scores
bit for bit, boxes within 1e-6).  Mask R-CNN: the FPN maps within 1e-5
in norm; its detections by the same rule; each matched row's mask
within 1e-5 in norm.
"""

from contextlib import contextmanager

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch import models as pmodels
from bigdl_tpu_torch.interop import nest_jax_parameters, state_buffers
from bigdl_tpu_torch.optim import validation as pval
from chip_smoke import detections_held

from test_torch_rnn import carry, one_torch_thread  # noqa: F401

SSD_CLASSES = 4


def near(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want),
                                                   1e-30)


@contextmanager
def zero_draws():
    """A context in which the reference's inits draw zeros."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0:
                   np.zeros(shape, np.float32))
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=None:
                   np.zeros(shape, np.float32))
        yield


def paired(make_ref, port):
    """The reference built with zero draws, the port's weights and
    buffers loaded into it, then carried back by name."""
    with zero_draws():
        ref = make_ref()
    ref.load_parameters(nest_jax_parameters(
        {n: p.detach().numpy() for n, p in port.named_parameters()}))
    ref.load_buffers(nest_jax_parameters(
        {n: b.numpy() for n, b in state_buffers(port).items()}))
    return ref, carry(ref, port)


def rows_of(rows):
    """(labels, scores, boxes) of an SSD output's non-empty rows."""
    rows = np.asarray(rows)
    kept = rows[rows[:, 1] > 0]
    return kept[:, 0], kept[:, 1], kept[:, 2:]


# ---- SSD-300 VGG16 ---------------------------------------------------------

@pytest.fixture(scope="module")
def ssd():
    torch.set_num_threads(1)
    port = pmodels.ssd_vgg16_300(
        SSD_CLASSES, generator=torch.Generator().manual_seed(0),
        device="cpu").eval()
    with torch.no_grad():   # class scores that spread
        for conf in port.conf_layers:
            conf.weight.mul_(20.0)
    ref, port = paired(lambda: jmodels.ssd_vgg16_300(
        class_num=SSD_CLASSES).eval_mode(), port)
    x = np.random.default_rng(0).normal(size=(1, 300, 300, 3)).astype(
        np.float32)
    params, rest = partition(ref)

    def forward(p, x):
        m = combine(p, rest)
        b = x.shape[0]
        srcs = m.feature_maps(x)
        locs = [l(s).reshape(b, -1) for l, s in zip(m.loc_layers, srcs)]
        confs = [c(s).reshape(b, -1) for c, s in zip(m.conf_layers, srcs)]
        priors = [p_(s) for p_, s in zip(m.prior_layers, srcs)]
        loc, conf, prior = (jnp.concatenate(a, 1)
                            for a in (locs, confs, priors))
        conf = jax.nn.softmax(conf.reshape(b, -1, m.class_num),
                              -1).reshape(b, -1)
        return loc, conf, prior, m.detection((loc, conf, prior)), \
            [s.shape for s in srcs]

    out = jax.jit(forward)(params, jnp.asarray(x))
    want = dict(zip(("loc", "conf", "prior", "rows"),
                    (np.asarray(a) for a in out[:4])))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        srcs = port.feature_maps(xt)
        loc, conf, prior = port.heads(xt)
        got = dict(loc=loc.numpy(), conf=conf.numpy(), prior=prior.numpy(),
                   rows=port(xt).numpy(),
                   from_reference=port.detection(
                       tuple(torch.tensor(want[k])
                             for k in ("loc", "conf", "prior"))).numpy())
    return dict(port=port, want=want, got=got,
                shapes=[tuple(s.shape[1:3]) for s in srcs])


def test_ssd_architecture(ssd):
    """tests/test_detection.py's canonical SSD-300: source maps
    38/19/10/5/3/1, 8,732 priors, [1, 200, 6] finite rows."""
    assert ssd["shapes"] == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3),
                             (1, 1)]
    assert ssd["got"]["prior"].shape == (2, 8732 * 4)
    assert ssd["got"]["rows"].shape == (1, 200, 6)
    assert np.isfinite(ssd["got"]["rows"]).all()
    names = {m.get_name() for m in ssd["port"].modules()
             if hasattr(m, "get_name")}
    assert {"conv1_1", "fc6", "fc7", "conv4_3_norm", "conv9_2_mbox_conf",
            "conv4_3_norm_mbox_loc"} <= names


def test_ssd_heads_and_priors_match_reference(ssd):
    got, want = ssd["got"], ssd["want"]
    near(got["loc"], want["loc"])
    near(got["conf"], want["conf"])
    np.testing.assert_array_equal(got["prior"], want["prior"])


def test_ssd_rows_match_reference(ssd):
    """The model's rows against the reference model's by the near-tie
    rule; and the port's DetectionOutputSSD on the reference's own loc,
    conf and priors equal to the reference's rows."""
    got, want = ssd["got"], ssd["want"]
    det = ssd["port"].detection
    conf = want["conf"].reshape(-1, SSD_CLASSES)
    # each class's top-k cut: a box near it may enter in one run only
    cuts = [np.sort(conf[:, c])[::-1][det.nms_topk - 1]
            for c in range(1, SSD_CLASSES)]
    near_rows, unexplained, pairs = detections_held(
        rows_of(got["rows"][0]), rows_of(want["rows"][0]), det.nms_thresh,
        thresholds=[det.conf_thresh, *cuts])
    assert not unexplained, (unexplained, near_rows)
    assert len(pairs) >= 190
    from_ref = got["from_reference"]
    np.testing.assert_array_equal(from_ref[..., :2], want["rows"][..., :2])
    np.testing.assert_allclose(from_ref[..., 2:], want["rows"][..., 2:],
                               rtol=0, atol=1e-6)


# ---- Mask R-CNN ------------------------------------------------------------

def maskrcnn_config(m):
    """tests/test_maskrcnn_map.py::test_maskrcnn_forward_shapes's small
    config."""
    return m.MaskRCNNParams(
        anchor_sizes=(16, 32, 64, 128, 256), pre_nms_topn_test=50,
        post_nms_topn_test=16, max_per_image=8, output_size=32,
        layers=(8, 8), box_score_thresh=0.0)


@pytest.fixture(scope="module")
def maskrcnn():
    torch.set_num_threads(1)
    port = pmodels.MaskRCNN(
        num_classes=5, config=maskrcnn_config(pmodels),
        generator=torch.Generator().manual_seed(1), device="cpu").eval()
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        # BatchNorm statistics from a seed, and logits and deltas that
        # spread, so that no decision lies within rounding
        for name, b in port.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
        port.rpn.cls_logits.weight.mul_(50.0)
        port.box_head.cls_score.weight.mul_(100.0)
        port.box_head.bbox_pred.weight.mul_(100.0)
    ref, port = paired(lambda: jmodels.MaskRCNN(
        num_classes=5, config=maskrcnn_config(jmodels)).eval_mode(), port)
    img = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    info = np.array([64.0, 64.0, 64.0, 64.0], np.float32)
    params, rest = partition(ref)

    def forward(p, img, info):
        m = combine(p, rest)
        return m.backbone(img), m((img, info))
    feats, outs = jax.jit(forward)(params, jnp.asarray(img),
                                   jnp.asarray(info))
    with torch.no_grad():
        x, i = torch.from_numpy(img), torch.from_numpy(info)
        got = dict(feats=[f.numpy() for f in port.backbone(x)],
                   outs=[o.numpy() for o in port((x, i))])
    return dict(got=got, want=dict(feats=[np.asarray(f) for f in feats],
                                   outs=[np.asarray(o) for o in outs]))


def test_maskrcnn_forward_shapes(maskrcnn):
    boxes, labels, scores, valid, masks = maskrcnn["got"]["outs"]
    assert boxes.shape == (8, 4)
    assert labels.shape == (8,) and scores.shape == (8,)
    assert valid.shape == (8,) and masks.shape == (8, 28, 28)
    assert (masks >= 0).all() and (masks <= 1).all()
    assert not masks[~valid].any()


def test_maskrcnn_matches_reference(maskrcnn):
    """The FPN maps; then boxes, labels, scores and validity by the
    near-tie rule and each matched row's mask."""
    got, want = maskrcnn["got"], maskrcnn["want"]
    for g, w in zip(got["feats"], want["feats"]):
        near(g, w)

    def held(outs):
        boxes, labels, scores, valid, _ = outs
        return labels[valid], scores[valid], boxes[valid]
    near_rows, unexplained, pairs = detections_held(
        held(got["outs"]), held(want["outs"]), 0.5, thresholds=[0.0])
    assert not unexplained, (unexplained, near_rows)
    assert len(pairs) == int(want["outs"][3].sum()) >= 6
    gm = got["outs"][4][got["outs"][3]]
    wm = want["outs"][4][want["outs"][3]]
    for g, w in pairs:
        near(gm[g], wm[w])


# ---- validation methods ----------------------------------------------------

def test_map_classification_perfect_and_half():
    m = pval.MeanAveragePrecision(classes=2)
    scores = torch.tensor([[0.9, 0.1], [0.8, 0.2], [0.1, 0.9], [0.2, 0.8]])
    target = torch.tensor([1.0, 1.0, 2.0, 2.0])
    res = m(scores, target)
    assert res.result()[0] == pytest.approx(1.0)
    assert (res + m(scores, target)).result()[0] == pytest.approx(1.0)


def test_map_classification_known_value():
    m = pval.MeanAveragePrecision(classes=1)
    val, _ = m(torch.tensor([[0.9], [0.8], [0.7]]),
               torch.tensor([1.0, 2.0, 1.0])).result()
    assert val == pytest.approx((1.0 + 2.0 / 3.0) / 2.0, rel=1e-6)


def test_precision_recall_auc_perfect():
    val, n = pval.PrecisionRecallAUC()(
        torch.tensor([0.9, 0.8, 0.2, 0.1]),
        torch.tensor([1.0, 1.0, 0.0, 0.0])).result()
    assert n == 4 and val == pytest.approx(1.0, abs=1e-6)


def test_tree_nn_accuracy():
    out = torch.tensor([[[0.1, 0.9], [0.5, 0.5]], [[0.8, 0.2], [0.5, 0.5]]])
    tgt = torch.tensor([[2.0, 1.0], [1.0, 1.0]])
    assert pval.TreeNNAccuracy()(out, tgt).result()[0] == pytest.approx(1.0)


def test_detection_map_voc():
    m = pval.MeanAveragePrecisionObjectDetection(classes=2, iou_thresh=0.5)
    gts = [(np.array([1, 2]), np.array([[0, 0, 10, 10], [20, 20, 30, 30]],
                                       np.float32))]
    dets = [(np.array([1, 2]), np.array([0.9, 0.8]),
             np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32))]
    assert m.evaluate(dets, gts) == pytest.approx(1.0)
    dets_half = [(np.array([1, 2]), np.array([0.9, 0.8]),
                  np.array([[0, 0, 10, 10], [25, 25, 40, 40]], np.float32))]
    assert m.evaluate(dets_half, gts) == pytest.approx(0.5)


def test_detection_map_voc07_and_coco_styles():
    gts = [(np.array([1]), np.array([[0, 0, 10, 10]], np.float32))]
    dets = [(np.array([1]), np.array([0.9]),
             np.array([[0, 0, 10, 10]], np.float32))]
    for style in ("VOC07", "COCO"):
        m = pval.MeanAveragePrecisionObjectDetection(classes=1, style=style)
        assert m.evaluate(dets, gts) == pytest.approx(1.0)
    dets_dup = [(np.array([1, 1]), np.array([0.9, 0.8]),
                 np.array([[0, 0, 10, 10], [0, 0, 10, 10]], np.float32))]
    m = pval.MeanAveragePrecisionObjectDetection(classes=1)
    assert m.evaluate(dets_dup, gts) == pytest.approx(1.0)


def _seeded_detections(seed, images=4, classes=3):
    """Random detections and ground truths, with tied scores, duplicate
    and missed boxes, images with no box of a class."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(images):
        m = int(rng.integers(1, 5))
        gbox = rng.random((m, 4)).astype(np.float32) * 50
        gbox[:, 2:] += gbox[:, :2] + 5
        glab = rng.integers(1, classes + 1, m)
        n = int(rng.integers(0, 7))
        pick = rng.integers(0, m, n)
        dbox = gbox[pick] + rng.normal(0, 3, (n, 4)).astype(np.float32)
        dlab = np.where(rng.random(n) < 0.8, glab[pick],
                        rng.integers(1, classes + 1, n))
        dsc = np.round(rng.random(n), 1).astype(np.float32)   # ties
        dets.append((dlab, dsc, dbox))
        gts.append((glab, gbox))
    return dets, gts


@pytest.mark.parametrize("style", ["VOC", "VOC07", "COCO"])
def test_detection_map_matches_reference_on_seeded_detections(style):
    for seed in range(3):
        dets, gts = _seeded_detections(seed)
        want = jval.MeanAveragePrecisionObjectDetection(
            3, 0.5, style).evaluate(dets, gts)
        assert pval.MeanAveragePrecisionObjectDetection(
            3, 0.5, style).evaluate(dets, gts) == want


def test_ranking_metrics_match_reference_on_seeded_scores():
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((40, 3)), 1).astype(np.float32)   # ties
    labels = rng.integers(1, 4, 40).astype(np.float32)
    for k, classes in ((None, 0), (5, 2)):
        got = pval.MeanAveragePrecision(k, classes)(
            torch.from_numpy(scores[:25]), torch.from_numpy(labels[:25])) \
            + pval.MeanAveragePrecision(k, classes)(
                torch.from_numpy(scores[25:]), torch.from_numpy(labels[25:]))
        want = jval.MeanAveragePrecision(k, classes)(
            jnp.asarray(scores[:25]), jnp.asarray(labels[:25])) \
            + jval.MeanAveragePrecision(k, classes)(
                jnp.asarray(scores[25:]), jnp.asarray(labels[25:]))
        assert got.result() == want.result()
    binary = (labels > 2).astype(np.float32)
    got = pval.PrecisionRecallAUC()(torch.from_numpy(scores[:, 0]),
                                    torch.from_numpy(binary))
    want = jval.PrecisionRecallAUC()(jnp.asarray(scores[:, 0]),
                                     jnp.asarray(binary))
    assert got.result()[0] == pytest.approx(want.result()[0], rel=1e-12)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_hit_ratio_and_ndcg_match_reference(k):
    """Seeded NCF-style scores (column 0 the positive) with ties against
    the positive, the rank counting only strictly higher scores."""
    rng = np.random.default_rng(k)
    scores = np.round(rng.random((64, 21)), 1).astype(np.float32)
    for name in ("HitRatio", "NDCG"):
        got = getattr(pval, name)(k)(torch.from_numpy(scores), None)
        want = getattr(jval, name)(k)(jnp.asarray(scores), None)
        assert got.fmt == want.fmt
        assert got.result()[1] == want.result()[1] == 64
        assert got.result()[0] == pytest.approx(want.result()[0], rel=1e-6)


def test_tree_nn_accuracy_matches_reference():
    rng = np.random.default_rng(5)
    out = rng.standard_normal((6, 4, 3)).astype(np.float32)
    tgt = rng.integers(1, 4, (6, 4)).astype(np.float32)
    for root in (-1, 0):
        got = pval.TreeNNAccuracy(root)(torch.from_numpy(out),
                                        torch.from_numpy(tgt))
        want = jval.TreeNNAccuracy(root)(jnp.asarray(out), jnp.asarray(tgt))
        assert got.result() == want.result()


def test_detection_map_refuses_the_evaluator():
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import Evaluator
    model = LeNet5(10, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    data = [Sample(np.zeros(784, np.float32), 1)]
    with pytest.raises(TypeError, match="host-side metric"):
        Evaluator(model, 1, device="cpu").evaluate(
            data, [pval.MeanAveragePrecisionObjectDetection(2)])


def test_validation_module_exports_every_reference_method():
    names = set(jval.__all__) - {"aggregate_across_processes"}
    assert names <= set(pval.__all__)
    from bigdl_tpu_torch import optim as poptim
    for name in ("HitRatio", "NDCG", "MeanAveragePrecision",
                 "MeanAveragePrecisionObjectDetection",
                 "PrecisionRecallAUC", "TreeNNAccuracy"):
        assert hasattr(poptim, name)
