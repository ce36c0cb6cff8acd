"""The port's zoo models (``models/inception.py``, ``models/vgg.py``,
``models/rnn_lm.py``, ``models/autoencoder.py`` and ``zoo()``) against
the JAX package's, on the CPU, all in train mode, weights and BatchNorm
buffers carried across by ``load_jax_parameters`` /
``load_jax_buffers``: the output, every parameter's gradient and the
input's, and the updated running statistics; and the
four models the perf CLI gained, trained through
``examples.perf.train(..., device="cpu")`` at tiny sizes.

Restates ``tests/test_serving.py`` :484-491 (the zoo registry) and
``tests/test_examples_cli.py`` :216-244 (Inception-v2's channel
progression and grid; that test is marked slow, this one runs at 32 px
and is not) and :506-516 (``--model ptb-lstm`` through the perf CLI).

The reference is built with its random draws stubbed to zeros and
takes the port's weights (drawn from a torch generator) before the
strict carry back checks every name and shape: threefry's per-shape
compiles made building Inception-v1 take 19 s on an 8-core CPU.  The
reference's forward and backward run under one ``jax.jit``: eagerly,
Inception-v1's took 26 s against 3 s jitted.

Tolerances, as in ``test_torch_resnet_models.py``: outputs rtol 1e-4,
atol 1e-4; gradients within 1e-3 of each tensor's largest entry (the
sums run in another order through every layer); running statistics rtol
1e-4, atol 1e-5.  The bias of a convolution that feeds a train-mode
BatchNorm has an exact gradient of zero (the batch mean takes it out),
so both frameworks return rounding noise there: it is held within 1e-3
of the largest entry of its layer's weight gradient instead.

The BatchNorm models are held where float32 is well conditioned,
measured against the port run in float64.  (1) Their BatchNorm biases are
drawn from U(-0.5, 0.5) (``shifted_biases``): with the init's zeros, a
channel constant over the batch leaves the sign after the BatchNorm to
rounding, and a ReLU then passes or stops its gradient by chance (either
framework's float32 gradients came 0.2-0.47 of a tensor's largest entry
off float64's, at random between them).  (2) ``VggForCifar10`` and
``Inception_v2`` run at batch 8, not 2: their last blocks normalise a
1 x 1 grid, over 2 values at batch 2, and both frameworks' gradients
then came up to 9e-3 off float64's.  (3) Among a million ReLU inputs
one may lie within rounding of zero, and the two frameworks then route
its gradient differently (up to 5.5e-2 of a tensor's largest entry at
input seeds 21 at batch 4 and 8 and at batch 16); as in
``test_torch_resnet_models.py``, the input (seed 19) has no such entry:
each framework's gradients lie within 1.1e-4 of float64's there.

chip_smoke.py's f32 steps of the two Inceptions (its ``ZOO_PARITY``
sizes and conditioning, restating no reference test) are held on the
CPU within 1e-3 in norm and of each tensor's largest entry of the same
step in float64 and of a step on inputs moved by 2^-23 of themselves.
"""

import copy

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import models as jmodels
from chip_smoke import (ZOO_PARITY, bn_fed_biases, parity_report,
                        zoo_parity_setup)
from bigdl_tpu_torch import models as pmodels
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.examples import perf
from bigdl_tpu_torch.interop import nest_jax_parameters, state_buffers

from test_torch_rnn import (carry, gen, one_torch_thread,  # noqa: F401
                            rnd, run_both)

OUT = dict(rtol=1e-4, atol=1e-4)
STATS = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-3


@pytest.fixture(autouse=True)
def zero_reference_draws(monkeypatch):
    """The reference's inits draw zeros: its weights come from the port."""
    def zeros(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return np.zeros(shape, np.float32)
    monkeypatch.setattr(jax.random, "uniform", zeros)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: np.zeros(
                            shape, np.float32))


def paired(ref, port):
    """The port's weights and buffers into the reference, then carried
    back by name (every name and shape checked)."""
    ref.load_parameters(nest_jax_parameters(
        {n: p.detach().numpy() for n, p in port.named_parameters()}))
    ref.load_buffers(nest_jax_parameters(
        {n: b.numpy() for n, b in state_buffers(port).items()}))
    return carry(ref, port)


def shifted_biases(port):
    """Every BatchNorm bias of ``port`` drawn from U(-0.5, 0.5)."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, pnn.BatchNormalization):
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) - 0.5)
    return port


def assert_model(want, got, fed=()):
    np.testing.assert_allclose(got["out"], want["out"], **OUT)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        scale = np.abs(want["grads"][fed[name]] if name in fed else w).max()
        np.testing.assert_allclose(got["grads"][name], w, rtol=0,
                                   atol=GRAD_REL * max(scale, 1e-12),
                                   err_msg=name)
    for g, w in zip(got["dx"], want["dx"]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())
    assert set(got["buffers"]) == set(want["buffers"])
    for name, w in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][name], w, **STATS,
                                   err_msg=name)


def _images(*shape, seed=17):
    return rnd(*shape, seed=seed)


def test_inception_v1_train_mode_matches_reference():
    ref = jmodels.Inception_v1(10, has_dropout=False)
    port = paired(ref, pmodels.Inception_v1(10, has_dropout=False, **gen()))
    assert port.i3a.name == "3a"
    assert port.stem[0].name == "conv1/7x7_s2"
    assert_model(*run_both(ref, port, [_images(2, 32, 32, 3)], train=True,
                           jit=True))


def test_inception_v1_dropout_acts_in_training_only():
    """The head's Dropout(0.4) draws from the generator in scope in
    training and is skipped in eval mode."""
    port = pmodels.Inception_v1(10, **gen())
    x = torch.tensor(_images(2, 32, 32, 3, seed=18))
    with torch.no_grad():
        port.eval()
        a, b = port(x), port(x)
        assert torch.equal(a, b)
        port.train()
        with pytest.raises(RuntimeError, match="No RNG in scope"):
            port(x)


def test_inception_v2_train_mode_matches_reference():
    """The output, every gradient and every BatchNorm's running
    statistics after one train-mode forward."""
    ref = jmodels.Inception_v2(10)
    port = paired(ref, shifted_biases(pmodels.Inception_v2(10, **gen())))
    assert [b.name for b in port.blocks][:3] == ["3a", "3b", "3c"]
    want, got = run_both(ref, port, [_images(8, 32, 32, 3, seed=19)],
                         train=True, jit=True)
    assert len(got["buffers"]) == 2 * 69
    fed = bn_fed_biases(port)
    assert len(fed) == 69
    assert_model(want, got, fed)


def test_inception_v2_channels_grid_and_odd_grid_refusal():
    """test_examples_cli.py:216: the channel progression through the ten
    blocks, the grid halved by 3c and 4e, log-probabilities out, and the
    grid-reduction block's refusal of an odd map."""
    m = pmodels.Inception_v2(class_num=5, **gen()).eval()
    x = torch.tensor(_images(2, 32, 32, 3, seed=20))
    with torch.no_grad():
        y = m.stem(x)
        widths, grids = [], []
        for b in m.blocks:
            y = b(y)
            widths.append(y.shape[-1])
            grids.append(y.shape[1])
        out = m(x)
    assert widths == [256, 320, 576, 576, 576, 576, 576, 1024, 1024, 1024]
    assert grids == [4, 4, 2, 2, 2, 2, 2, 1, 1, 1]
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="3c.*even feature map"):
        m(torch.zeros(1, 40, 40, 3))


def test_vgg_cifar10_train_mode_matches_reference():
    ref = jmodels.VggForCifar10(10, has_dropout=False)
    port = paired(ref, shifted_biases(
        pmodels.VggForCifar10(10, has_dropout=False, **gen())))
    fed = bn_fed_biases(port)
    assert len(fed) == 14
    assert_model(*run_both(ref, port, [_images(8, 32, 32, 3, seed=19)],
                           train=True, jit=True), fed)


def test_vgg16_forward_and_head_gradient_match_reference():
    """Vgg_16 at 224 px (its head is Linear(512 * 7 * 7, 4096)): the
    output and the gradients of the three Linear layers, the rest frozen
    in both (the costliest case, so the only one at this size)."""
    ref = jmodels.Vgg_16(10, has_dropout=False)
    port = paired(ref, pmodels.Vgg_16(10, has_dropout=False, **gen()))
    convs = [f"layers[{i}]" for i, m in enumerate(ref.layers)
             if type(m).__name__ == "SpatialConvolution"]
    ref.freeze(*convs)
    for name, p in port.named_parameters():
        p.requires_grad_(f"layers[{name.split('.')[1]}]" not in convs)
    want, got = run_both(ref, port, [_images(1, 224, 224, 3, seed=22)],
                         train=True, jit=True, grad_inputs=False)
    heads = [n for n, p in port.named_parameters() if p.requires_grad]
    assert len(heads) == 6 and set(want["grads"]) == set(heads)
    got["grads"] = {n: got["grads"][n] for n in heads}
    assert_model(want, got)


def test_ptb_model_train_mode_matches_reference():
    """PTBModel(50, 16): LookupTable, two LSTMs in a MultiRNNCell, the
    TimeDistributed decoder and log_softmax, over (4, 8) 1-based ids."""
    ref = jmodels.PTBModel(50, 16)
    port = paired(ref, pmodels.PTBModel(50, 16, **gen()))
    ids = np.random.default_rng(23).integers(1, 51, (4, 8)).astype(np.int32)
    assert_model(*run_both(ref, port, [ids], train=True, jit=True))


def test_ptb_model_one_layer_and_dropout():
    """One layer is a bare LSTM through Recurrent; the dropout before
    the decoder draws in training only."""
    ref = jmodels.PTBModel(30, 8, num_layers=1)
    port = paired(ref, pmodels.PTBModel(30, 8, num_layers=1, **gen()))
    ids = np.random.default_rng(24).integers(1, 31, (2, 5)).astype(np.int32)
    assert_model(*run_both(ref, port, [ids], train=True, jit=True))
    m = pmodels.PTBModel(30, 8, num_layers=1, dropout=0.5, **gen()).eval()
    x = torch.tensor(ids)
    assert torch.equal(m(x), m(x))
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        m.train()(x)


def test_simple_rnn_and_autoencoder_match_reference():
    ref = jmodels.SimpleRNN(10, 8, 10)
    port = paired(ref, pmodels.SimpleRNN(10, 8, 10, **gen()))
    assert_model(*run_both(ref, port, [_images(2, 5, 10, seed=25)],
                           train=True, jit=True))
    ref = jmodels.autoencoder(16)
    port = paired(ref, pmodels.autoencoder(16, **gen()))
    assert isinstance(port, pmodels.Autoencoder)
    assert_model(*run_both(ref, port, [_images(3, 28, 28, 1, seed=26)],
                           train=True, jit=True))


# ---- zoo() -------------------------------------------------------------------

def test_zoo_registry():
    """test_serving.py:484: the reference's names and sample shapes;
    every name builds."""
    from bigdl_tpu.models import _ZOO, _ZOO_SAMPLE_SHAPES
    assert set(pmodels._ZOO) == set(_ZOO)
    assert pmodels._ZOO_SAMPLE_SHAPES == _ZOO_SAMPLE_SHAPES
    m = pmodels.zoo("autoencoder", **gen())
    assert hasattr(m, "forward")
    assert pmodels.zoo_sample_shape("lenet5") == (784,)
    for name in sorted(pmodels._ZOO):
        model = pmodels.zoo(name, **gen())
        assert sum(p.numel() for p in model.parameters()) > 0
    m = pmodels.zoo("lenet5", class_num=7, **gen())
    assert m[-2].weight.shape[0] == 7
    with pytest.raises(ValueError):
        pmodels.zoo("not_a_model")
    with pytest.raises(ValueError):
        pmodels.zoo_sample_shape("not_a_model")


# ---- the perf CLI ------------------------------------------------------------

PERF_TINY = {
    "inception-v1": ["-b", "2", "--image-size", "32", "--classes", "10",
                     "--iterations", "2", "--epochs", "2"],
    "inception-v2": ["-b", "2", "--image-size", "32", "--classes", "10",
                     "--iterations", "2", "--epochs", "2"],
    "vgg16": ["-b", "1", "--image-size", "224", "--classes", "10",
              "--iterations", "1", "--epochs", "2"],
    # test_examples_cli.py:506, the reference's own tiny PTB run
    "ptb-lstm": ["-b", "8", "--seq-len", "8", "--vocab-size", "50",
                 "--hidden-size", "16", "--num-layers", "2",
                 "--iterations", "2", "--epochs", "3"],
}


@pytest.mark.parametrize("model", sorted(PERF_TINY))
def test_perf_trains_the_model(model):
    argv = ["--model", model, *PERF_TINY[model], "--device", "cpu"]
    out, opt = perf.train(perf.parse_args(argv))
    assert out["model"] == model and out["records_per_sec"] > 0
    assert out["windows_timed"] >= 1
    losses = [loss for _, loss in opt.loss_history]
    args = perf.parse_args(argv)
    assert len(losses) == args.iterations * args.epochs
    assert np.isfinite(losses).all()


def test_perf_ptb_and_inception_builds_load_the_reference_builds():
    """The port's perf builds carry the reference's parameter names and
    shapes (the flat LM's ``lm.`` prefix among them) and its criterion."""
    from bigdl_tpu.examples import perf as jperf
    for model, argv in (("ptb-lstm", PERF_TINY["ptb-lstm"]),
                        ("inception-v1", PERF_TINY["inception-v1"])):
        args = perf.parse_args(["--model", model, *argv, "--device", "cpu"])
        ref, jcrit, _ = jperf.build(model, args)
        port, crit, make_batch = perf.build(model, args)
        paired(ref, port)
        assert type(crit).__name__ == type(jcrit).__name__
        x, y = make_batch(args.batch_size)
        assert x.shape[0] == args.batch_size


def test_perf_without_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.main(["--model", "ptb-lstm", *PERF_TINY["ptb-lstm"]],
                  emit=False)


@pytest.mark.parametrize("model", ["inception-v1", "inception-v2"])
def test_chip_parity_steps_are_stable_in_float32(model):
    """chip_smoke's f32 step of each Inception (``ZOO_PARITY``'s size and
    conditioning) lies on the CPU within 1e-3 of the same step in float64
    and of a step on inputs moved by 2^-23 of themselves: no ReLU or max
    pool there routes a gradient by a rounding, so the card's step can be
    held against the CPU's by fixed bounds.  (VGG-16's step at 224 px
    is read on the card, beside TF32's, by chip_gate_controls.py.)"""
    net, _, step, what = zoo_parity_setup(model, device="cpu")
    fed = bn_fed_biases(net)
    exact = step(copy.deepcopy(net).double(), "cpu", torch.float64)
    moved = step(copy.deepcopy(net), "cpu", perturb=0)
    f32 = step(net, "cpu")
    bounds = (1e-5, 1e-3, 1e-3)
    assert parity_report(f32, exact, f"{model} f32", bounds, what,
                         ("f32", "float64"), fed)[2]
    assert parity_report(moved, f32, f"{model} moved", bounds, what,
                         ("inputs moved by 2^-23", "f32"), fed)[2]
    assert ZOO_PARITY[model][2][1:] == (1e-2, 5e-2)
