"""LeNet-5 (``models/lenet.py``) and ``resnet_cifar(20)`` through the
port's ``Optimizer`` against the JAX package's, on the CPU, from the
same numpy batches and bridged weights: the forward of ``LeNet5`` and
``lenet5_graph``, and a fixed-seed 20-step float32 trajectory of each
model with every-epoch validation, whose Top1 counts must be equal.

Tolerances: the forward rtol 1e-5, atol 1e-6.  The trajectories: each
iteration's loss rtol 1e-5, every parameter 1e-4 relative in norm
(||port - ref|| / ||ref||) after 20 SGD steps -- the reference runs its
step as an SPMD program over 8 CPU devices, so its sums go in another
order and momentum carries the difference (measured on the CPU: the
losses 1.1e-7 apart, the parameters 2.5e-6 in norm for LeNet and 4.9e-5
for resnet_cifar(20)).
"""

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Top1Accuracy as JTop1
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_buffers, load_jax_parameters
from bigdl_tpu_torch.models import LeNet5, lenet5_graph, resnet_cifar
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.validation import Top1Accuracy

LOSS_RTOL, PARAM_NORM_REL = 1e-5, 1e-4
GEN = dict(generator=torch.Generator().manual_seed(0), device="cpu")


def mnist_batches(n, batch, seed):
    """Images as the reference perf's ``mnist_batch`` makes them, with a
    class-dependent offset so that validation has something to count."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(1, 11, size=(batch,))
        x = rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)
        x[:, :10, :10, 0] += (y[:, None, None] - 5.5).astype(np.float32) / 3
        out.append((x, y))
    return out


@pytest.mark.parametrize("graph", [False, True])
def test_lenet_forward_matches_reference(graph):
    set_seed(1)
    ref = jmodels.lenet5_graph(10) if graph else jmodels.LeNet5(10)
    port = (lenet5_graph if graph else LeNet5)(10, **GEN)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    x = mnist_batches(1, 4, 2)[0][0]
    np.testing.assert_allclose(
        port(torch.tensor(x)).detach().numpy(),
        np.asarray(ref(jax.numpy.asarray(x))), rtol=1e-5, atol=1e-6)
    # the flat input of the reference's Reshape(batch_mode=True)
    np.testing.assert_allclose(
        port(torch.tensor(x.reshape(4, 784))).detach().numpy(),
        np.asarray(ref(jax.numpy.asarray(x.reshape(4, 784)))),
        rtol=1e-5, atol=1e-6)


def test_lenet_names_its_layers_as_the_reference():
    port = LeNet5(10, **GEN)
    names = [m.name for m in port.modules()
             if isinstance(m, (pnn.Linear, pnn.SpatialConvolution))]
    assert names == ["conv1_5x5", "conv2_5x5", "fc1", "fc2"]


def _recorder(n_steps, trigger_cls):
    """An end trigger that stops after ``n_steps`` and reads every
    iteration's loss (forcing per-iteration readback) and the score at
    each epoch's end."""
    losses, scores = {}, []

    def fn(s):
        if s["neval"] > 1:
            losses[s["neval"] - 1] = s["loss"]
        if s.get("is_epoch_end") and (not scores or scores[-1][0]
                                      != s["neval"]):
            scores.append((s["neval"], s["score"]))
        return s["neval"] > n_steps
    return trigger_cls(fn, "record", needs_loss=True), losses, scores


def trajectory(ref, port, criteria, batches, val_batches, epochs):
    """Train both from the same weights, ``len(batches) * epochs`` SGD
    steps with validation every epoch; returns the per-iteration losses
    and scores of both."""
    n_steps = len(batches) * epochs
    jt, ref_losses, ref_scores = _recorder(n_steps, JTrigger)
    (JOptimizer(ref, JDataSet.array([JMiniBatch(x, y) for x, y in batches],
                                    shuffle=False), criteria[0])
     .set_optim_method(JSGD(0.05, momentum=0.9, dampening=0.0))
     .set_end_when(jt)
     .set_validation(JTrigger.every_epoch(),
                     JDataSet.array([JMiniBatch(x, y)
                                     for x, y in val_batches],
                                    shuffle=False), [JTop1()])
     .optimize())
    pt, port_losses, port_scores = _recorder(n_steps, Trigger)
    opt = (Optimizer(port, DataSet.array([MiniBatch(x, y)
                                          for x, y in batches],
                                         shuffle=False), criteria[1])
           .set_optim_method(SGD(0.05, momentum=0.9, dampening=0.0))
           .set_end_when(pt)
           .set_validation(Trigger.every_epoch(),
                           DataSet.array([MiniBatch(x, y)
                                          for x, y in val_batches],
                                         shuffle=False), [Top1Accuracy()]))
    opt.optimize()
    assert [loss for _, loss in opt.loss_history] == \
        [port_losses[i] for i in sorted(port_losses)]
    return (ref_losses, ref_scores, port_losses, port_scores, opt)


def assert_trajectories(ref, port, ref_losses, ref_scores, port_losses,
                        port_scores, n_val, n_steps):
    assert sorted(ref_losses) == sorted(port_losses) == \
        list(range(1, n_steps + 1))
    np.testing.assert_allclose([port_losses[i] for i in range(1, n_steps + 1)],
                               [ref_losses[i] for i in range(1, n_steps + 1)],
                               rtol=LOSS_RTOL)
    # the same iterations validated, the same Top1 counts
    assert [n for n, _ in port_scores] == [n for n, _ in ref_scores]
    assert [round(s * n_val) for _, s in port_scores] == \
        [round(s * n_val) for _, s in ref_scores]
    want = flatten_jax_parameters(ref.parameters())
    for name, p in port.named_parameters():
        w = torch.tensor(want[name])
        assert float((p.detach() - w).norm() / w.norm()) <= PARAM_NORM_REL, \
            name


@pytest.mark.parametrize("graph", [False, True])
def test_lenet_trajectory_matches_reference(graph):
    set_seed(2)
    ref = jmodels.lenet5_graph(10) if graph else jmodels.LeNet5(10)
    port = (lenet5_graph if graph else LeNet5)(10, **GEN)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    batches = mnist_batches(5, 16, 3)
    val = mnist_batches(4, 16, 4)
    *run, opt = trajectory(ref, port, (jnn.ClassNLLCriterion(),
                                       pnn.ClassNLLCriterion()),
                           batches, val, epochs=4)
    assert_trajectories(ref, port, *run, n_val=64, n_steps=20)
    assert [n for n, _ in opt.validation_history] == [6, 11, 16, 21]
    assert run[3][-1][1] > run[3][0][1] or run[3][0][1] == 1.0


def test_resnet_cifar_trajectory_matches_reference():
    set_seed(3)
    ref = jmodels.resnet_cifar(20, 10)
    port = resnet_cifar(20, 10, **GEN)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    load_jax_buffers(port, jax.tree_util.tree_map(np.asarray,
                                                  ref.buffers()))
    rng = np.random.default_rng(5)

    def cifar(n):
        return [(rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                 rng.integers(1, 11, size=(8,))) for _ in range(n)]
    batches, val = cifar(5), cifar(2)
    *run, _ = trajectory(ref, port, (jnn.CrossEntropyCriterion(),
                                     pnn.CrossEntropyCriterion()),
                         batches, val, epochs=4)
    assert_trajectories(ref, port, *run, n_val=16, n_steps=20)
    want = flatten_jax_parameters(ref.buffers())
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_perf_cli_trains_lenet(capsys):
    """``--model lenet`` as the reference's perf builds it (LeNet5(10),
    ClassNLL, normal images [b, 28, 28, 1], labels 1..10), and the same
    run with a dispatch window of an epoch's iterations: the same
    losses, bit for bit."""
    from bigdl_tpu_torch.examples import perf
    argv = ["--model", "lenet", "-b", "32", "--iterations", "4",
            "--epochs", "3", "--device", "cpu"]
    out = perf.main(argv)
    assert out["model"] == "lenet" and out["windows_timed"] == 2
    assert capsys.readouterr().out.strip().startswith("{")
    args = perf.parse_args(argv)
    runs = [perf.run(args, *perf.build("lenet", args),
                     configure=lambda o: o.set_iterations_per_dispatch(k))[1]
            for k in (1, 4)]
    assert runs[0].loss_history == runs[1].loss_history
    assert runs[1].dispatch_stats["window_steps"] == 12
