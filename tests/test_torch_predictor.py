"""The port's inference runtime (``bigdl_tpu_torch.optim.predictor``:
Predictor, Evaluator, PredictionService) against the JAX package's, on
the CPU: ``tests/test_predictor.py`` restated on LeNet-5, with weights
carried across and inputs made with numpy from a seed; the entry points'
refusals; and ResNet-50 in eval mode at ``__graft_entry__.entry()``'s
input, ``(8, 224, 224, 3)`` of ones, and at random images with random
BatchNorm scales and running statistics carried across.

Tolerances: LeNet-5's outputs rtol 1e-5, atol 1e-6 (float32, the sums
in another order); counts and classes exactly.  ResNet-50's logits
within 1e-5 of max|logit| (measured on the CPU: 1.2e-7 at the entry's
input, where the logits are about 0.024 at most and equal across rows,
and 7.2e-7 at the random images, where they reach about 930).
"""

import io
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__
from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset.dataset import Sample as JSample
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.interop import load_jax_buffers, load_jax_parameters
from bigdl_tpu_torch.models import LeNet5, resnet50
from bigdl_tpu_torch.optim import (Evaluator, Loss, PredictionService,
                                   Predictor, Top1Accuracy, Top5Accuracy)
from bigdl_tpu_torch.optim import predictor as ppredictor
from bigdl_tpu_torch.serving import ModelServer

OUT = dict(rtol=1e-5, atol=1e-6)
RESNET_REL = 1e-5
CPU = dict(device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lenet():
    set_seed(3)
    ref = jmodels.LeNet5(10)
    port = LeNet5(10, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    return ref, load_jax_parameters(port, _np(ref.parameters()))


def images(n, seed):
    return list(np.random.default_rng(seed).normal(size=(n, 28, 28, 1))
                .astype(np.float32))


def labels(n, seed):
    return np.random.default_rng(seed).integers(1, 11, n)


def ref_forward(ref, xs):
    return np.asarray(ref.clone().eval_mode().forward(jnp.stack(
        [jnp.asarray(x) for x in xs])))


# ---- tests/test_predictor.py restated --------------------------------------

def test_predict_matches_forward(lenet):
    ref, port = lenet
    feats = images(10, 0)
    preds = Predictor(port, batch_size=4, **CPU).predict(
        [Sample(f) for f in feats])
    assert len(preds) == 10  # ragged tail (10 = 2*4 + 2) included
    want = joptim.Predictor(ref, batch_size=4).predict(
        [JSample(f) for f in feats])
    np.testing.assert_allclose(np.stack(preds), np.stack(want), **OUT)
    np.testing.assert_allclose(np.stack(preds), ref_forward(ref, feats),
                               **OUT)


def test_predict_class_is_one_based(lenet):
    ref, port = lenet
    feats = images(6, 1)
    classes = Predictor(port, batch_size=4, **CPU).predict_class(
        [Sample(f) for f in feats])
    assert classes.shape == (6,) and set(classes) <= set(range(1, 11))
    want = joptim.Predictor(ref, batch_size=4).predict_class(
        [JSample(f) for f in feats])
    np.testing.assert_array_equal(classes, want)


def test_module_predict_convenience(lenet):
    _, port = lenet
    out = port.predict([Sample(f) for f in images(4, 2)], batch_size=4,
                       **CPU)
    assert len(out) == 4 and out[0].shape == (10,)
    assert port.predict_class((np.stack(images(3, 2)), labels(3, 2)),
                              batch_size=2, **CPU).shape == (3,)


def test_evaluator_counts_every_sample(lenet):
    ref, port = lenet
    feats, ys = images(11, 3), labels(11, 3)
    results = Evaluator(port, batch_size=4, **CPU).evaluate(
        [Sample(f, int(y)) for f, y in zip(feats, ys)],
        [Top1Accuracy(), Top5Accuracy(), Loss(pnn.ClassNLLCriterion())])
    want = joptim.Evaluator(ref, batch_size=4).evaluate(
        [JSample(f, int(y)) for f, y in zip(feats, ys)],
        [joptim.Top1Accuracy(), joptim.Top5Accuracy(),
         joptim.Loss(jnn.ClassNLLCriterion())])
    for (got, _), (exp, _) in zip(results, want):
        assert got.result()[1] == exp.result()[1] == 11
        np.testing.assert_allclose(got.result()[0], exp.result()[0],
                                   rtol=1e-5)
    assert np.isfinite(results[2][0].result()[0])


def test_evaluate_on_transformed_dataset(lenet):
    _, port = lenet
    samples = [Sample(f, int(y)) for f, y in zip(images(8, 4), labels(8, 4))]
    ds = LocalDataSet(samples, shuffle=False).transform(SampleToMiniBatch(4))
    results = port.evaluate(ds, [Top1Accuracy()], **CPU)
    assert results[0][0].result()[1] == 8


def test_prediction_service_concurrent(lenet):
    ref, port = lenet
    svc = PredictionService(port, concurrency=3, **CPU)
    xs = [np.stack(images(2, 5 + i)) for i in range(12)]
    outs = [None] * len(xs)
    errs = []

    def work(i):
        try:
            outs[i] = svc.predict(xs[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(xs))]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs
    for x, y in zip(xs, outs):
        np.testing.assert_allclose(y, ref_forward(ref, list(x)), **OUT)


def test_prediction_service_bytes_roundtrip(lenet):
    _, port = lenet
    svc = PredictionService(port, **CPU)
    x = np.stack(images(2, 6))
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    y = np.load(io.BytesIO(svc.predict_bytes(buf.getvalue())),
                allow_pickle=False)
    assert y.shape == (2, 10)


# ---- beyond the reference's own tests --------------------------------------

def test_ragged_padding_repeats_the_last_sample():
    from bigdl_tpu.optim.predictor import _pad_batch as jpad
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(ppredictor._pad_batch(x, 5), jpad(x, 5))
    cols = ppredictor._pad_batch((x, x[:, :1]), 4)
    assert isinstance(cols, tuple) and cols[1].shape == (4, 1)
    np.testing.assert_array_equal(cols[0][3], x[2])


def test_jit_forward_clones_once_in_eval_mode(lenet):
    _, port = lenet
    port.train()
    model, fn = ppredictor.jit_forward(port, "cpu")
    assert port.training and not model.training
    assert model.layers[1].weight.data_ptr() != \
        port.layers[1].weight.data_ptr()
    y = fn(model, np.stack(images(2, 7)).astype(np.float64))
    assert y.dtype == torch.float32 and y.is_inference()


def test_entry_points_refuse_the_cpu_unless_asked(lenet, monkeypatch):
    _, port = lenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Predictor(port), lambda: Evaluator(port),
                 lambda: PredictionService(port),
                 lambda: ModelServer(port),
                 lambda: ModelServer(lambda x: x),
                 lambda: ppredictor.jit_forward(port)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert len(Predictor(port, **CPU).predict(images(1, 8))) == 1


def test_a_model_on_another_device_is_refused(lenet, monkeypatch):
    """The port never moves a model behind its caller's back: a CPU
    model given to a CUDA entry point raises before anything runs."""
    _, port = lenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for make in (lambda: Predictor(port, device="cuda"),
                 lambda: PredictionService(port, device="cuda"),
                 lambda: ModelServer(port, device="cuda")):
        with pytest.raises(ValueError, match="lies on cpu"):
            make()


# ---- ResNet-50 in eval mode ------------------------------------------------

@pytest.fixture(scope="module")
def resnet_pair():
    """``__graft_entry__.entry()``'s model and input, its forward jitted
    once (a second set of weights of the same shapes reuses the
    compile), and the port's resnet50(1000) carrying its weights."""
    fn, (ref, x) = __graft_entry__.entry()
    port = resnet50(1000, generator=torch.Generator().manual_seed(0),
                    device="cpu").eval()
    load_jax_parameters(port, _np(ref.parameters()))
    load_jax_buffers(port, _np(ref.buffers()))
    return jax.jit(fn), ref, port, np.asarray(x)


def _held(got, want):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= RESNET_REL * scale, (err, scale)


def test_resnet50_eval_at_the_entry_input(resnet_pair):
    fn, ref, port, x = resnet_pair
    assert x.shape == (8, 224, 224, 3) and (x == 1).all()
    want = np.asarray(fn(ref, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.tensor(x)).numpy()
    assert got.shape == (8, 1000) and np.isfinite(got).all()
    _held(got, want)


def test_resnet50_eval_at_random_images_through_the_predictor(resnet_pair):
    """Random BatchNorm scales and running statistics (so that every
    block and every statistic counts) and random images, on which rows
    and classes differ; the Predictor's logits and 1-based classes."""
    fn, ref, port, _ = resnet_pair
    rng = np.random.default_rng(0)

    def randomize(tree, leaf):
        return {k: randomize(v, leaf) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}
    params = randomize(_np(ref.parameters()), lambda k, v: (
        rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if k == "weight" and v.ndim == 1 else v))
    buffers = randomize(_np(ref.buffers()), lambda k, v: (
        rng.normal(0, 0.1, v.shape) if k == "running_mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32))
    twin = ref.clone()
    twin.load_parameters(params)
    twin.load_buffers(buffers)
    model = load_jax_buffers(load_jax_parameters(
        resnet50(1000, generator=torch.Generator().manual_seed(0),
                 device="cpu"), params), buffers)
    x = rng.normal(size=(8, 224, 224, 3)).astype(np.float32)
    want = np.asarray(fn(twin, jnp.asarray(x)))
    # every row differs from the first, and the classes within a row
    assert np.abs(want[1:] - want[0]).max(axis=1).min() > 1.0
    assert want.std(axis=1).min() > 1.0
    predictor = Predictor(model, batch_size=8, **CPU)
    got = np.stack(predictor.predict(list(x)))
    _held(got, want)
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1.0   # no near-tie
    np.testing.assert_array_equal(predictor.predict_class(list(x)),
                                  want.argmax(axis=1) + 1)
    assert model.training   # the Predictor ran an eval-mode clone
