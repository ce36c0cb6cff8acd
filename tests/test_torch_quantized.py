"""The port's ``nn/quantized.py`` against the JAX package's, on the CPU.

The int8 layers are held bit for bit: from the same float weights (carried
by name), ``qweight``, ``wscale``, the int8 activations and the int32
accumulators equal the reference's (its ``_quantize_rows`` and its
``dot_general`` / ``conv_general_dilated`` with ``preferred_element_type
= int32``), and the outputs within rtol 1e-6, atol 1e-6 (bit for bit is
expected: the epilogue is the same three float32 roundings).  The port's
``_int_mm`` path (padded to its shape rules: LeNet's K 25 and N 6, one
row) is held against its float64 plain version, and a quantized model's
buffers load from the reference's by name.

Restates ``tests/test_quantized.py`` :18, :31, :40, :52, :75, :82 (the
reference jits the model; here repeated calls under ``torch.no_grad``),
:94, :115, :122 (LeNet-5 trained in-suite), :162 (a ResNet of Bottlenecks
[1, 1, 1, 1] at 64 px, so it is not slow; its bounds) and :186, and
``tests/test_serving.py`` :332 (one-shot serving of an int8 model).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core.module import clone
from bigdl_tpu_torch.interop import flatten_jax_parameters, load_jax_buffers
from bigdl_tpu_torch.nn import quantized as pq
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          Quantizer, quantize)

from chip_smoke import int_mm_calls, plain_products
from test_torch_rnn import carry, gen, one_torch_thread, rnd  # noqa: F401

EXACT = dict(rtol=1e-6, atol=1e-6)


def _ref_acc_linear(ref_q, qx):
    return np.asarray(jax.lax.dot_general(
        jnp.asarray(qx), ref_q.qweight, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))


def _ref_acc_conv(ref_q, qx):
    pad = ref_q.pad
    padding = "SAME" if pad[0] == -1 else ((pad[0], pad[0]),
                                           (pad[1], pad[1]))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(qx), ref_q.qweight, window_strides=ref_q.stride,
        padding=padding, rhs_dilation=ref_q.dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


def _held(ref_q, port_q, x, conv):
    """Every int8 quantity of the port's layer equal to the reference's,
    the output within EXACT."""
    np.testing.assert_array_equal(port_q.qweight.numpy(),
                                  np.asarray(ref_q.qweight))
    np.testing.assert_array_equal(port_q.wscale.numpy(),
                                  np.asarray(ref_q.wscale))
    xt = torch.tensor(x)
    if conv and port_q.data_format == "NCHW":
        xt = xt.permute(0, 2, 3, 1)
        x = np.transpose(x, (0, 2, 3, 1))
    qx_ref, sx_ref = jq._quantize_rows(jnp.asarray(x))
    qx, sx, acc = port_q.accumulate(xt)
    np.testing.assert_array_equal(qx.numpy(), np.asarray(qx_ref))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_ref))
    want_acc = (_ref_acc_conv if conv else _ref_acc_linear)(ref_q, qx_ref)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    with plain_products():
        np.testing.assert_array_equal(port_q.accumulate(xt)[2].numpy(),
                                      want_acc)


LINEARS = [("b8", 32, 16, (8, 32)), ("lenet_fc", 25, 6, (3, 25)),
           ("one_row", 8, 4, (1, 8)), ("head", 64, 10, (5, 64))]


@pytest.mark.parametrize("name,nin,nout,shape", LINEARS,
                         ids=[c[0] for c in LINEARS])
def test_quantized_linear_bit_for_bit(name, nin, nout, shape):
    set_seed(len(name))
    ref = jnn.Linear(nin, nout)
    port = carry(ref, pnn.Linear(nin, nout, **gen()))
    ref_q, port_q = jq.QuantizedLinear(ref), QuantizedLinear(port)
    x = rnd(*shape, seed=1)
    _held(ref_q, port_q, x, conv=False)
    np.testing.assert_allclose(port_q(torch.tensor(x)).numpy(),
                               np.asarray(ref_q(jnp.asarray(x))), **EXACT)


# name, constructor (module, kwargs), NHWC input shape
CONVS = [
    ("plain", lambda m, k: m.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **k),
     (2, 8, 8, 3)),
    ("lenet_conv1", lambda m, k: m.SpatialConvolution(1, 6, 5, 5, **k),
     (2, 12, 12, 1)),
    ("same", lambda m, k: m.SpatialConvolution(4, 8, 3, 3, 1, 1, -1, -1,
                                               **k), (2, 7, 9, 4)),
    ("strided_stem", lambda m, k: m.SpatialConvolution(
        3, 16, 7, 7, 2, 2, 3, 3, with_bias=False, **k), (2, 17, 17, 3)),
    ("strided_same", lambda m, k: m.SpatialConvolution(8, 8, 3, 3, 2, 2, -1,
                                                       -1, **k),
     (1, 10, 11, 8)),
    ("pointwise", lambda m, k: m.SpatialConvolution(16, 24, 1, 1, **k),
     (2, 5, 5, 16)),
    ("dilated_fc6", lambda m, k: m.SpatialDilatedConvolution(
        8, 16, 3, 3, 1, 1, 6, 6, 6, 6, **k), (2, 15, 15, 8)),
    ("dilated_strided", lambda m, k: m.SpatialDilatedConvolution(
        3, 8, 3, 3, 2, 2, 2, 2, 2, 2, **k), (2, 10, 10, 3)),
    ("nchw", lambda m, k: m.SpatialConvolution(
        3, 8, 3, 3, 1, 1, 1, 1, data_format="NCHW", **k), (2, 3, 8, 8)),
]


@pytest.mark.parametrize("name,make,shape", CONVS, ids=[c[0] for c in CONVS])
def test_quantized_conv_bit_for_bit(name, make, shape):
    set_seed(len(name) + 7)
    ref = make(jnn, {})
    port = carry(ref, make(pnn, gen(3)))
    ref_q, port_q = jq.QuantizedSpatialConvolution(ref), \
        QuantizedSpatialConvolution(port)
    x = rnd(*shape, seed=2)
    _held(ref_q, port_q, x, conv=True)
    np.testing.assert_allclose(port_q(torch.tensor(x)).numpy(),
                               np.asarray(ref_q(jnp.asarray(x))), **EXACT)


def test_quantized_bf16_rows_bit_for_bit():
    """A bfloat16 input quantizes in bfloat16 in both packages (amax / 127,
    x / scale, round) and the output comes back in bfloat16."""
    set_seed(11)
    ref = jnn.Linear(16, 8)
    port = carry(ref, pnn.Linear(16, 8, **gen()))
    x = rnd(6, 16, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    qx_ref, sx_ref = jq._quantize_rows(xb)
    qx, sx = pq._quantize_rows(torch.tensor(x).to(torch.bfloat16))
    np.testing.assert_array_equal(qx.numpy(), np.asarray(qx_ref))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_ref))
    out = QuantizedLinear(port)(torch.tensor(x).to(torch.bfloat16))
    want = jq.QuantizedLinear(ref)(xb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_round_is_half_to_even_and_scale_one_for_zero_rows():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5], [0.0] * 6])
    q, s = pq._quantize_rows(x)
    assert q[0].tolist() == [127, 0, 2, 2, -2, 0]
    assert s[:, 0].tolist() == [1.0, 1.0] and q[1].abs().sum() == 0
    w = torch.tensor([[2.54, -1.27], [0.0, 0.0]])
    qw, sw = pq._quantize_per_channel(w, 0)
    np.testing.assert_array_equal(sw.reshape(-1).numpy(),
                                  np.float32([2.54 / 127.0, 1.0]))
    assert qw[1].abs().sum() == 0


def test_int_mm_path_pads_to_its_shape_rules():
    """K 25 and N 6 (LeNet's conv1), one row: the operands are padded to
    24 rows and multiples of 8, the sums sliced back, equal to the
    float64 product; each call counts once."""
    rng = np.random.default_rng(0)
    qx = torch.tensor(rng.integers(-127, 128, size=(1, 25)), dtype=torch.int8)
    qw = torch.tensor(rng.integers(-127, 128, size=(6, 25)), dtype=torch.int8)
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    torch._int_mm = spy
    try:
        got = pq.int8_matmul(qx, qw)
    finally:
        torch._int_mm = real
    assert seen == [((24, 32), (32, 8))]
    assert tuple(got.shape) == (1, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  pq.plain_int8_matmul(qx, qw).numpy())


def test_conv_columns_chunked_over_the_batch(monkeypatch):
    """With the column budget below one image the batch runs an image a
    chunk, to the same sums."""
    set_seed(2)
    conv = QuantizedSpatialConvolution(pnn.SpatialConvolution(
        3, 8, 3, 3, 1, 1, 1, 1, **gen()))
    x = torch.tensor(rnd(3, 6, 6, 3, seed=4))
    whole = conv.accumulate(x)[2]
    monkeypatch.setattr(pq, "COLUMN_BYTES", 1)
    with int_mm_calls() as calls:
        chunked = conv.accumulate(x)[2]
    assert calls[0] == 3
    assert torch.equal(whole, chunked)


# ---- tests/test_quantized.py restated ----------------------------------------

def test_quantized_linear_close_to_float():
    lin = pnn.Linear(32, 16, **gen(0))
    qlin = QuantizedLinear(lin)
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 32)),
                     dtype=torch.float32)
    want, got = lin(x).detach(), qlin(x)
    rel = (got - want).abs() / (want.abs().max() + 1e-8)
    assert rel.max() < 0.02, rel.max()


def test_quantized_linear_1d_input():
    qlin = QuantizedLinear(pnn.Linear(8, 4, **gen(1)))
    x = torch.tensor(np.random.default_rng(1).normal(size=(8,)),
                     dtype=torch.float32)
    assert tuple(qlin(x).shape) == (4,)


def test_quantized_conv_close_to_float():
    conv = pnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **gen(2))
    qconv = QuantizedSpatialConvolution(conv)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 8, 8, 3)),
                     dtype=torch.float32)
    want, got = conv(x).detach(), qconv(x)
    rel = (got - want).abs() / (want.abs().max() + 1e-8)
    assert rel.max() < 0.03, rel.max()


def _toy(m, **g):
    return m.Sequential(
        m.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, **g), m.ReLU(),
        m.SpatialMaxPooling(2, 2), m.Reshape((4 * 4 * 4,)),
        m.Linear(64, 10, **g), m.LogSoftMax())


def test_quantize_swaps_layers_and_preserves_decisions():
    """The reference's toy model, its weights (set_seed(3)) carried
    across."""
    set_seed(3)
    model = carry(_toy(jnn), _toy(pnn, **gen(3)))
    q = quantize(model)
    assert type(model.layers[0]) is pnn.SpatialConvolution
    assert type(q.layers[0]) is QuantizedSpatialConvolution
    assert type(q.layers[4]) is QuantizedLinear
    x = torch.tensor(np.random.default_rng(3).normal(size=(16, 8, 8, 1)),
                     dtype=torch.float32)
    with torch.no_grad():
        want_cls = model.eval_mode()(x).argmax(1)
        got_cls = q(x).argmax(1)
    assert (want_cls == got_cls).float().mean() >= 0.95


def test_quantized_weights_are_not_trainable():
    q = quantize(pnn.Linear(4, 2, **gen(4)))
    assert list(q.parameters()) == []
    assert q.qweight.dtype == torch.int8
    assert set(dict(q.named_buffers())) == {"qweight", "wscale", "bias"}


def test_quantized_model_repeated_calls():
    q = quantize(pnn.Sequential(pnn.Linear(8, 8, **gen(5)), pnn.ReLU(),
                                pnn.Linear(8, 2, **gen(6))))
    x = torch.ones((4, 8))
    with torch.no_grad():
        ys = [q(x) for _ in range(3)]
    assert tuple(ys[0].shape) == (4, 2) and torch.isfinite(ys[0]).all()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def test_quantize_ncf_scores_close():
    from bigdl_tpu_torch.models import NeuralCF
    m = NeuralCF(20, 30, embed_dim=8, **gen(0)).eval()
    rng = np.random.default_rng(0)
    pairs = torch.tensor(np.stack([rng.integers(1, 21, size=(16,)),
                                   rng.integers(1, 31, size=(16,))], -1),
                         dtype=torch.int32)
    with torch.no_grad():
        base = m(pairs)
        q = Quantizer.quantize(m)
        n_q = sum(isinstance(mod, QuantizedLinear) for mod in q.modules())
        assert n_q == 4, n_q
        assert (q(pairs) - base).abs().max() < 0.05


def test_module_quantize_convenience():
    m = pnn.Sequential(pnn.Linear(4, 4, **gen(6)))
    q = m.quantize()
    assert type(q.layers[0]) is QuantizedLinear
    assert type(m.layers[0]) is pnn.Linear and m.training


def test_grouped_conv_stays_float_and_subclasses_are_not_swapped():
    m = pnn.Sequential(
        pnn.SpatialConvolution(4, 4, 3, 3, n_group=2, **gen(7)),
        pnn.SpatialShareConvolution(4, 4, 1, 1, **gen(8)))
    q = quantize(m)
    assert type(q.layers[0]) is pnn.SpatialConvolution
    assert type(q.layers[1]) is pnn.SpatialShareConvolution


def test_int8_accuracy_delta_on_trained_lenet():
    """tests/test_quantized.py:122: LeNet-5 trained in-suite on learnable
    synthetic MNIST, the fp32 -> int8 top-1 delta under 1% through the
    Evaluator."""
    from bigdl_tpu_torch.dataset import (DataSet, SampleToMiniBatch,
                                         synthetic_mnist)
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy,
                                       Trigger)
    from bigdl_tpu_torch.optim.predictor import Evaluator

    samples = synthetic_mnist(768, seed=0)
    train, test = samples[:512], samples[512:]
    data = DataSet.array(train, seed=0).transform(SampleToMiniBatch(64))
    model = LeNet5(10, **gen(0))
    (Optimizer(model, data, pnn.ClassNLLCriterion(), seed=0)
     .set_optim_method(SGD(0.1))
     .set_end_when(Trigger.max_epoch(6))
     .optimize())
    model = model.eval_mode()
    quantized = Quantizer.quantize(model)
    eval_data = DataSet.array(test, shuffle=False).transform(
        SampleToMiniBatch(64))
    accs = {}
    for tag, m in (("fp32", model), ("int8", quantized)):
        (res, _), = Evaluator(m, 64, device="cpu").evaluate(
            eval_data, [Top1Accuracy()])
        accs[tag] = float(res.result()[0])
    assert accs["fp32"] > 0.9, accs
    assert abs(accs["fp32"] - accs["int8"]) < 0.01, accs


def test_int8_resnet_shape_fidelity():
    """tests/test_quantized.py:162's bounds on a ResNet of Bottlenecks
    [1, 1, 1, 1] (the stem, every stage's first block and the head) at 64
    px: relative L2 under 0.05, top-1 agreement at least 0.75."""
    from bigdl_tpu_torch.models.resnet import Bottleneck, ResNet
    model = ResNet(Bottleneck, [1, 1, 1, 1], 1000, **gen(0)).eval()
    quant = Quantizer.quantize(model)
    x = torch.tensor(np.random.default_rng(0).normal(size=(4, 64, 64, 3)),
                     dtype=torch.float32)
    with torch.no_grad():
        out_f, out_q = model(x), quant(x)
    rel = float((out_q - out_f).norm() / out_f.norm())
    agree = float((out_f.argmax(1) == out_q.argmax(1)).float().mean())
    assert rel < 0.05, rel
    assert agree >= 0.75, agree
    assert torch.isfinite(out_q).all()
    n_conv = sum(type(m) is QuantizedSpatialConvolution
                 for m in quant.modules())
    assert n_conv == 1 + 4 * 4 and type(quant.head) is QuantizedLinear


def test_quantized_dilated_conv_preserves_dilation():
    conv = pnn.SpatialDilatedConvolution(3, 8, 3, 3, 1, 1, 2, 2, 2, 2,
                                         **gen(7))
    q = quantize(conv)
    assert q.dilation == (2, 2)
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 10, 10, 3)),
                     dtype=torch.float32)
    want, got = conv(x).detach(), q(x)
    assert want.shape == got.shape
    rel = (got - want).abs() / (want.abs().max() + 1e-8)
    assert rel.max() < 0.03, rel.max()


# ---- whole models against the reference ---------------------------------------

def test_quantized_lenet_matches_the_reference():
    """LeNet-5 quantized in both packages from the same weights: every
    int8 layer's buffers equal, the reference's quantized buffers load
    into the port's by name, and the log-probabilities agree (tanh and
    the pools between the int8 layers are float32 in each framework)."""
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu_torch.models import LeNet5
    set_seed(0)
    ref = JLeNet5(10)
    port = carry(ref, LeNet5(10, **gen(0)))
    ref_q, port_q = jq.quantize(ref), quantize(port)
    buffers = jax.tree_util.tree_map(np.asarray, ref_q.buffers())
    mine = {n: b.numpy() for n, b in port_q.named_buffers()}
    theirs = flatten_jax_parameters(buffers)
    assert set(mine) == set(theirs)
    for n in mine:
        np.testing.assert_array_equal(mine[n], theirs[n], err_msg=n)
    loaded = load_jax_buffers(clone(port_q), buffers)
    x = rnd(6, 28, 28, 1, seed=5)
    with torch.no_grad():
        got = port_q(torch.tensor(x)).numpy()
        np.testing.assert_array_equal(loaded(torch.tensor(x)).numpy(), got)
    np.testing.assert_allclose(got, np.asarray(ref_q(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_one_shot_serving_of_an_int8_model():
    """tests/test_serving.py:332: the served rows of quantize(lenet5)
    equal the quantized model's own batch forward: per-row quantization
    makes the bucket's padded rows inert."""
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.serving import ModelServer
    qmodel = quantize(LeNet5(10, **gen(0)))
    server = ModelServer(qmodel, max_batch=4, batch_timeout_ms=10.0,
                         device="cpu")
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(28, 28, 1)).astype(np.float32) for _ in range(5)]
    try:
        outs = server.submit_many(xs, timeout=30)
    finally:
        server.shutdown()
    with torch.no_grad():
        want = qmodel(torch.tensor(np.stack(xs))).numpy()
    np.testing.assert_allclose(np.stack(outs), want, rtol=1e-5, atol=1e-6)
