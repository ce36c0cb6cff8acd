"""The port's ``nn/criterion.py`` against the JAX package's, on the CPU:
every export of the reference's ``__all__``, forward and ``backward``
(the input's gradient) from the same numpy-seeded inputs, or waived with
a reason; then ``tests/test_criterions.py``'s 22 tests restated against
the port (torch.nn.functional as their oracle, 1-based targets adjusted
at the boundary), the grad sweep of :290 as parametrised cases.

Tolerance against the reference: float32 rtol 1e-5, atol 1e-6 on the
loss and on every gradient; the restated tests keep their own
(``RTOL``, ``ATOL`` and the 1e-3 of some, as there).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import criterion as jc
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import criterion as pc

from test_torch_rnn import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
RTOL, ATOL = 1e-4, 1e-5


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def sig01(*shape, seed=0):
    return (1 / (1 + np.exp(-rnd(*shape, seed=seed)))).astype(np.float32)


def signs(*shape, seed=0):
    return np.sign(rnd(*shape, seed=seed)).astype(np.float32)


def labels(n, classes, seed=0):
    return np.random.RandomState(seed).randint(1, classes + 1, size=(n,))


def logp(*shape, seed=0):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(rnd(*shape, seed=seed))))


def softmax(*shape, seed=0):
    return np.asarray(jax.nn.softmax(jnp.asarray(rnd(*shape, seed=seed))))


W6 = np.array([0.1, 0.5, 1.0, 2.0, 0.3, 1.5], np.float32)

# export: (build(module of criteria, nn package), input, target); a tuple
# input is a table
CASES = {
    "ClassNLLCriterion": (lambda c, n: c.ClassNLLCriterion(W6),
                          logp(5, 6), labels(5, 6, 1)),
    "ClassNLLCriterion_padding": (
        lambda c, n: c.ClassNLLCriterion(size_average=False,
                                         logProbAsInput=False,
                                         paddingValue=3),
        softmax(6, 4), np.array([1, 3, 2, 4, 3, 1])),
    "CrossEntropyCriterion": (lambda c, n: c.CrossEntropyCriterion(),
                              rnd(6, 5), labels(6, 5, 2)),
    "CategoricalCrossEntropy": (lambda c, n: c.CategoricalCrossEntropy(),
                                softmax(4, 5),
                                np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]),
    "BCECriterion": (lambda c, n: c.BCECriterion(sig01(4, 3, seed=7)),
                     sig01(4, 3), (rnd(4, 3, seed=2) > 0)
                     .astype(np.float32)),
    "MSECriterion": (lambda c, n: c.MSECriterion(size_average=False),
                     rnd(4, 5), rnd(4, 5, seed=1)),
    "AbsCriterion": (lambda c, n: c.AbsCriterion(), rnd(4, 5),
                     rnd(4, 5, seed=1)),
    "SmoothL1Criterion": (lambda c, n: c.SmoothL1Criterion(), rnd(4, 5),
                          3 * rnd(4, 5, seed=1)),
    "DistKLDivCriterion": (lambda c, n: c.DistKLDivCriterion(), logp(4, 6),
                           softmax(4, 6, seed=1)),
    "KLDCriterion": (lambda c, n: c.KLDCriterion(),
                     (rnd(3, 4), 0.5 * rnd(3, 4, seed=1)), None),
    "GaussianCriterion": (lambda c, n: c.GaussianCriterion(),
                          (rnd(3, 4), 0.5 * rnd(3, 4, seed=1)),
                          rnd(3, 4, seed=2)),
    "CosineEmbeddingCriterion": (
        lambda c, n: c.CosineEmbeddingCriterion(0.3),
        (rnd(4, 8), rnd(4, 8, seed=1)),
        np.array([1, -1, 1, -1], np.float32)),
    "HingeEmbeddingCriterion": (lambda c, n: c.HingeEmbeddingCriterion(0.7),
                                rnd(10), signs(10, seed=1)),
    "MarginCriterion": (lambda c, n: c.MarginCriterion(0.8, squared=True),
                        rnd(4, 3), signs(4, 3, seed=1)),
    "MarginRankingCriterion": (
        lambda c, n: c.MarginRankingCriterion(0.5),
        (rnd(8), rnd(8, seed=1)), signs(8, seed=2)),
    "MultiCriterion": (lambda c, n: c.MultiCriterion()
                       .add(c.MSECriterion(), 0.5).add(c.AbsCriterion(), 2.0),
                       rnd(3, 4), rnd(3, 4, seed=1)),
    "ParallelCriterion": (lambda c, n: c.ParallelCriterion()
                          .add(c.MSECriterion(), 0.5)
                          .add(c.ClassNLLCriterion(), 2.0),
                          (rnd(3, 4), logp(3, 5, seed=1)),
                          (rnd(3, 4, seed=2), labels(3, 5, 3))),
    "ParallelCriterion_repeat": (lambda c, n: c.ParallelCriterion(True)
                                 .add(c.MSECriterion())
                                 .add(c.AbsCriterion(), 0.3),
                                 (rnd(3, 4), rnd(3, 4, seed=1)),
                                 rnd(3, 4, seed=2)),
    "MultiLabelMarginCriterion": (
        lambda c, n: c.MultiLabelMarginCriterion(), rnd(3, 6),
        np.array([[2, 4, 0, 0, 0, 0], [1, 0, 5, 0, 0, 0],
                  [3, 5, 6, 1, 0, 0]])),
    "MultiLabelSoftMarginCriterion": (
        lambda c, n: c.MultiLabelSoftMarginCriterion(W6[:5]), rnd(4, 5),
        (rnd(4, 5, seed=3) > 0).astype(np.float32)),
    "MultiMarginCriterion": (
        lambda c, n: c.MultiMarginCriterion(p=2, weights=W6, margin=0.7),
        rnd(5, 6), labels(5, 6, 4)),
    "SoftMarginCriterion": (lambda c, n: c.SoftMarginCriterion(), rnd(6, 4),
                            signs(6, 4, seed=1)),
    "L1HingeEmbeddingCriterion": (
        lambda c, n: c.L1HingeEmbeddingCriterion(4.0),
        (rnd(4, 3), rnd(4, 3, seed=1)), np.array([1, -1, -1, 1],
                                                 np.float32)),
    "CosineDistanceCriterion": (lambda c, n: c.CosineDistanceCriterion(),
                                rnd(4, 6), rnd(4, 6, seed=1)),
    "CosineProximityCriterion": (lambda c, n: c.CosineProximityCriterion(),
                                 rnd(4, 6), rnd(4, 6, seed=1)),
    "DotProductCriterion": (lambda c, n: c.DotProductCriterion(True),
                            rnd(4, 6), rnd(4, 6, seed=1)),
    "PoissonCriterion": (lambda c, n: c.PoissonCriterion(),
                         sig01(4, 5) + 0.5, sig01(4, 5, seed=1)),
    "MeanAbsolutePercentageCriterion": (
        lambda c, n: c.MeanAbsolutePercentageCriterion(), rnd(4, 5),
        rnd(4, 5, seed=1)),
    "MeanSquaredLogarithmicCriterion": (
        lambda c, n: c.MeanSquaredLogarithmicCriterion(), sig01(4, 5) * 3,
        sig01(4, 5, seed=1) * 3),
    "KullbackLeiblerDivergenceCriterion": (
        lambda c, n: c.KullbackLeiblerDivergenceCriterion(), softmax(4, 5),
        softmax(4, 5, seed=1)),
    "ClassSimplexCriterion": (lambda c, n: c.ClassSimplexCriterion(5),
                              rnd(4, 5), labels(4, 5, 5)),
    "L1Cost": (lambda c, n: c.L1Cost(), rnd(4, 5), None),
    "DiceCoefficientCriterion": (
        lambda c, n: c.DiceCoefficientCriterion(epsilon=0.5),
        sig01(3, 4, 5), (rnd(3, 4, 5, seed=1) > 0).astype(np.float32)),
    "PGCriterion": (lambda c, n: c.PGCriterion(), softmax(4, 5),
                    rnd(4, 5, seed=1)),
    "TimeDistributedCriterion": (
        lambda c, n: c.TimeDistributedCriterion(c.ClassNLLCriterion(), True),
        logp(2, 3, 5), np.array([[1, 2, 3], [4, 5, 1]])),
    "TimeDistributedCriterion_dim3": (
        lambda c, n: c.TimeDistributedCriterion(c.MSECriterion(), False, 3),
        rnd(2, 3, 4), rnd(2, 3, 4, seed=1)),
    "TimeDistributedMaskCriterion": (
        lambda c, n: c.TimeDistributedMaskCriterion(
            c.ClassNLLCriterion(paddingValue=0), True),
        logp(2, 4, 5), np.array([[1, 2, 0, 0], [4, 5, 1, 0]])),
    "TransformerCriterion": (
        lambda c, n: c.TransformerCriterion(c.MSECriterion(), n.Tanh(),
                                            n.Sigmoid()),
        rnd(3, 4), rnd(3, 4, seed=1)),
}

WAIVED = {"Criterion": "the abstract base: its forward raises in both "
                       "packages; its backward is every case's backward"}


def _jax(x):
    if isinstance(x, tuple):
        return tuple(_jax(v) for v in x)
    return None if x is None else jnp.asarray(x)


def _torch(x, grad=False):
    if isinstance(x, tuple):
        return tuple(_torch(v, grad) for v in x)
    if x is None:
        return None
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _case_export(name):
    return name.split("_")[0] if name.split("_")[0] in jc.__all__ else name


def test_every_export_is_held_or_waived():
    assert set(jc.__all__) == set(pc.__all__)
    held = {_case_export(n) for n in CASES}
    assert held | set(WAIVED) == set(jc.__all__), \
        set(jc.__all__) - held - set(WAIVED)
    for name in jc.__all__:
        assert hasattr(pnn, name), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_backward_match_the_reference(name):
    build, x, t = CASES[name]
    ref, port = build(jc, jnn), build(pc, pnn)
    # jitted: one compile each, where the eager ops compile one by one
    want = jax.jit(ref.forward)(_jax(x), _jax(t))
    got = port(_torch(x), _torch(t))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    want_g = jax.jit(ref.backward)(_jax(x), _jax(t))
    got_g = port.backward(_torch(x), _torch(t))
    if isinstance(x, tuple):
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f"input {i}")
    else:
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def test_backward_leaves_the_input_alone():
    x = torch.tensor(rnd(3, 4))
    g = pc.MSECriterion().backward(x, torch.zeros(3, 4))
    assert not x.requires_grad and x.grad is None
    torch.testing.assert_close(g, 2 * x / x.numel())


# ---- tests/test_criterions.py restated ---------------------------------

def test_classnll_matches_torch():
    lp = logp(5, 7)
    target = np.array([1, 3, 7, 2, 5])
    ours = pnn.ClassNLLCriterion()(torch.tensor(lp), torch.tensor(target))
    ref = F.nll_loss(torch.tensor(lp), torch.tensor(target - 1))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def test_classnll_with_weights_matches_torch():
    lp = logp(5, 4)
    target = np.array([1, 2, 3, 4, 2])
    w = np.array([0.2, 0.5, 1.0, 2.0], dtype=np.float32)
    ours = pnn.ClassNLLCriterion(weights=w)(torch.tensor(lp),
                                            torch.tensor(target))
    ref = F.nll_loss(torch.tensor(lp), torch.tensor(target - 1),
                     weight=torch.tensor(w))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def test_crossentropy_matches_torch():
    logits = rnd(6, 9)
    target = np.array([1, 2, 3, 4, 5, 9])
    ours = pnn.CrossEntropyCriterion()(torch.tensor(logits),
                                       torch.tensor(target))
    ref = F.cross_entropy(torch.tensor(logits), torch.tensor(target - 1))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def test_mse_and_abs_match_torch():
    a, b = torch.tensor(rnd(4, 5)), torch.tensor(rnd(4, 5, seed=1))
    np.testing.assert_allclose(float(pnn.MSECriterion()(a, b)),
                               float(F.mse_loss(a, b)), rtol=RTOL)
    np.testing.assert_allclose(float(pnn.AbsCriterion()(a, b)),
                               float(F.l1_loss(a, b)), rtol=RTOL)


def test_bce_matches_torch():
    p = torch.tensor(1 / (1 + np.exp(-rnd(6, 3))))
    t = torch.tensor((rnd(6, 3, seed=2) > 0).astype(np.float32))
    np.testing.assert_allclose(float(pnn.BCECriterion()(p, t)),
                               float(F.binary_cross_entropy(p, t)),
                               rtol=1e-3)


def test_smoothl1_matches_torch():
    a, b = torch.tensor(rnd(4, 5)), torch.tensor(rnd(4, 5, seed=1) * 3)
    np.testing.assert_allclose(float(pnn.SmoothL1Criterion()(a, b)),
                               float(F.smooth_l1_loss(a, b)), rtol=RTOL)


def test_distkldiv_matches_torch():
    lp, t = torch.tensor(logp(4, 6)), torch.tensor(softmax(4, 6, seed=1))
    np.testing.assert_allclose(float(pnn.DistKLDivCriterion()(lp, t)),
                               float(F.kl_div(lp, t, reduction="mean")),
                               rtol=1e-3)


def test_margin_ranking_matches_torch():
    x1, x2 = torch.tensor(rnd(8)), torch.tensor(rnd(8, seed=1))
    y = torch.tensor(signs(8, seed=2))
    ours = pnn.MarginRankingCriterion(margin=0.5)((x1, x2), y)
    ref = F.margin_ranking_loss(x1, x2, y, margin=0.5)
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def test_multimargin_matches_torch():
    x = torch.tensor(rnd(5, 6))
    t = np.array([1, 4, 2, 6, 3])
    ours = pnn.MultiMarginCriterion()(x, torch.tensor(t))
    ref = F.multi_margin_loss(x, torch.tensor(t - 1))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


def test_soft_margin_matches_torch():
    x, y = torch.tensor(rnd(6, 4)), torch.tensor(signs(6, 4, seed=1))
    np.testing.assert_allclose(float(pnn.SoftMarginCriterion()(x, y)),
                               float(F.soft_margin_loss(x, y)), rtol=RTOL)


def test_cosine_embedding_matches_torch():
    x1, x2 = torch.tensor(rnd(4, 8)), torch.tensor(rnd(4, 8, seed=1))
    y = torch.tensor([1, -1, 1, -1], dtype=torch.float32)
    ours = pnn.CosineEmbeddingCriterion(margin=0.3)((x1, x2), y)
    ref = F.cosine_embedding_loss(x1, x2, y, margin=0.3)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


def test_hinge_embedding_matches_torch():
    x, y = torch.tensor(rnd(10)), torch.tensor(signs(10, seed=1))
    ours = pnn.HingeEmbeddingCriterion(margin=1.0)(x, y)
    np.testing.assert_allclose(float(ours),
                               float(F.hinge_embedding_loss(x, y)),
                               rtol=RTOL)


def test_multilabel_soft_margin_matches_torch():
    x = torch.tensor(rnd(4, 5))
    t = torch.tensor((rnd(4, 5, seed=3) > 0).astype(np.float32))
    np.testing.assert_allclose(
        float(pnn.MultiLabelSoftMarginCriterion()(x, t)),
        float(F.multilabel_soft_margin_loss(x, t)), rtol=1e-3)


def _multilabel_target(t):
    tt = torch.tensor(t - 1)
    tt[torch.tensor(t) == 0] = -1
    return tt


def test_multilabel_margin_matches_torch():
    x = torch.tensor(rnd(3, 6))
    t = np.array([[2, 4, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0],
                  [3, 5, 6, 0, 0, 0]])
    ours = pnn.MultiLabelMarginCriterion()(x, torch.tensor(t))
    ref = F.multilabel_margin_loss(x, _multilabel_target(t))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


def test_criterion_backward_matches_torch():
    logits = rnd(4, 5)
    target = np.array([1, 2, 3, 4])
    gi = pnn.CrossEntropyCriterion().backward(torch.tensor(logits),
                                              torch.tensor(target))
    xt = torch.tensor(logits, requires_grad=True)
    F.cross_entropy(xt, torch.tensor(target - 1)).backward()
    np.testing.assert_allclose(gi.numpy(), xt.grad.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_parallel_and_multi_criterion():
    a, b = torch.tensor(rnd(3, 4)), torch.tensor(rnd(3, 4, seed=1))
    pcrit = pnn.ParallelCriterion().add(pnn.MSECriterion(), 0.5) \
        .add(pnn.AbsCriterion(), 2.0)
    loss = pcrit((a, a * 0), (b, b))
    expect = 0.5 * float(pnn.MSECriterion()(a, b)) \
        + 2.0 * float(pnn.AbsCriterion()(a * 0, b))
    np.testing.assert_allclose(float(loss), expect, rtol=RTOL)
    mc = pnn.MultiCriterion().add(pnn.MSECriterion()).add(pnn.AbsCriterion())
    expect2 = float(pnn.MSECriterion()(a, b)) + float(pnn.AbsCriterion()(a, b))
    np.testing.assert_allclose(float(mc(a, b)), expect2, rtol=RTOL)


def test_kld_vae_criterion():
    z = torch.zeros((2, 4))
    assert float(pnn.KLDCriterion()((z, z))) == pytest.approx(0.0)


def test_timedistributed_criterion():
    lp = logp(2, 3, 5)
    t = np.array([[1, 2, 3], [4, 5, 1]])
    ours_sa = pnn.TimeDistributedCriterion(pnn.ClassNLLCriterion(), True, 2)(
        torch.tensor(lp), torch.tensor(t))
    ours_sum = pnn.TimeDistributedCriterion(pnn.ClassNLLCriterion(), False,
                                            2)(torch.tensor(lp),
                                               torch.tensor(t))
    per_step = [F.nll_loss(torch.tensor(lp[:, i]), torch.tensor(t[:, i] - 1))
                for i in range(3)]
    expect_sum = float(sum(per_step))
    np.testing.assert_allclose(float(ours_sum), expect_sum, rtol=1e-3)
    np.testing.assert_allclose(float(ours_sa), expect_sum / 3, rtol=1e-3)


def test_multimargin_weights_applied():
    x = torch.tensor(rnd(5, 6))
    t = np.array([1, 4, 2, 6, 3])
    ours = pnn.MultiMarginCriterion(weights=W6)(x, torch.tensor(t))
    ref = F.multi_margin_loss(x, torch.tensor(t - 1),
                              weight=torch.tensor(W6))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


def test_multilabel_margin_stops_at_first_zero():
    x = torch.tensor(rnd(1, 6))
    t = np.array([[2, 0, 4, 0, 0, 0]])  # only class 2 is a target
    ours = pnn.MultiLabelMarginCriterion()(x, torch.tensor(t))
    ref = F.multilabel_margin_loss(x, _multilabel_target(t))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


def test_distkldiv_divides_by_nelement():
    lp, t = torch.tensor(logp(4, 6)), torch.tensor(softmax(4, 6, seed=1))
    ours = pnn.DistKLDivCriterion(size_average=True)(lp, t)
    ref = F.kl_div(lp, t, reduction="mean")
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-3)


GRAD_CASES = [
    ("MSE", lambda: pnn.MSECriterion(), lambda a, t: F.mse_loss(a, t),
     lambda: (rnd(4, 5, seed=1), rnd(4, 5, seed=2))),
    ("Abs", lambda: pnn.AbsCriterion(), lambda a, t: F.l1_loss(a, t),
     lambda: (rnd(4, 5, seed=3), rnd(4, 5, seed=4))),
    ("BCE", lambda: pnn.BCECriterion(),
     lambda a, t: F.binary_cross_entropy(a, t),
     lambda: (sig01(4, 5, seed=5), (rnd(4, 5, seed=6) > 0)
              .astype(np.float32))),
    ("SmoothL1", lambda: pnn.SmoothL1Criterion(),
     lambda a, t: F.smooth_l1_loss(a, t),
     lambda: (rnd(4, 5, seed=7), rnd(4, 5, seed=8))),
    ("SoftMargin", lambda: pnn.SoftMarginCriterion(),
     lambda a, t: F.soft_margin_loss(a, t),
     lambda: (rnd(4, 5, seed=9), signs(4, 5, seed=10))),
    ("ClassNLL", lambda: pnn.ClassNLLCriterion(),
     lambda a, t: F.nll_loss(a, t),
     lambda: (np.log(sig01(6, 4, seed=11) + 0.1),
              np.random.RandomState(12).randint(1, 5, size=(6,)))),
    ("CrossEntropy", lambda: pnn.CrossEntropyCriterion(),
     lambda a, t: F.cross_entropy(a, t),
     lambda: (rnd(6, 4, seed=13),
              np.random.RandomState(14).randint(1, 5, size=(6,)))),
    ("DistKLDiv", lambda: pnn.DistKLDivCriterion(),
     lambda a, t: F.kl_div(a, t, reduction="batchmean") * t.shape[0]
     / t.numel(),
     lambda: (np.log(sig01(4, 5, seed=15) + 0.05), sig01(4, 5, seed=16))),
    ("Poisson", lambda: pnn.PoissonCriterion(),
     lambda a, t: F.poisson_nll_loss(torch.log(a), t, log_input=True,
                                     full=False),
     lambda: (sig01(4, 5, seed=17) + 0.5, sig01(4, 5, seed=18))),
    ("MultiMargin", lambda: pnn.MultiMarginCriterion(),
     lambda a, t: F.multi_margin_loss(a, t),
     lambda: (rnd(6, 4, seed=19),
              np.random.RandomState(20).randint(1, 5, size=(6,)))),
    ("HingeEmbedding", lambda: pnn.HingeEmbeddingCriterion(margin=1.0),
     lambda a, t: F.hinge_embedding_loss(a, t, margin=1.0),
     lambda: (np.abs(rnd(4, 5, seed=21)), signs(4, 5, seed=22))),
    ("MultiLabelSoftMargin", lambda: pnn.MultiLabelSoftMarginCriterion(),
     lambda a, t: F.multilabel_soft_margin_loss(a, t),
     lambda: (rnd(4, 5, seed=23), (rnd(4, 5, seed=24) > 0)
              .astype(np.float32))),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c[0])
def test_criterion_grad_sweep(case):
    name, make_ours, torch_fn, make_io = case
    a_np, t_np = make_io()
    one_based = name in ("ClassNLL", "CrossEntropy", "MultiMargin")
    g_ours = make_ours().backward(torch.tensor(a_np), torch.tensor(t_np))
    ta = torch.tensor(a_np, requires_grad=True)
    tt = torch.tensor(t_np - 1) if one_based else torch.tensor(t_np)
    torch_fn(ta, tt).backward()
    np.testing.assert_allclose(g_ours.numpy(), ta.grad.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
