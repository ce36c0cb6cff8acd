"""The port's LeNet layer tranche (``nn/activation.py``,
``nn/shape_ops.py``, ``nn/containers.py`` and the average pools of
``nn/pooling.py``) against the JAX package's, on the CPU: every class,
forward and the gradient of each floating input, from the same numpy
inputs and cotangents, parameters carried across by
``load_jax_parameters`` (containers load by the reference's
``layers[i]`` and ``graph_modules[i]`` names).

Tolerance: float32 rtol 1e-5, atol 1e-6 (the same formula in both
frameworks, one rounding or operation order apart); the containers,
whose Linear layers sum in another order, rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.interop import load_jax_parameters

TOL = dict(rtol=1e-5, atol=1e-6)
CONTAINER_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def pos(*shape, seed=0):
    return np.abs(rnd(*shape, seed=seed)) + 0.1


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check(ref, port, inputs, table=False, tol=TOL, seed=50):
    """Run ``ref`` (JAX) and ``port`` (torch) on ``inputs`` (numpy; a
    table when ``table``) and hold the outputs and the gradients of the
    floating inputs, through the same random cotangents."""
    float_at = [i for i, a in enumerate(inputs)
                if np.issubdtype(np.asarray(a).dtype, np.floating)]

    def call(m, xs):
        return m(tuple(xs)) if table else m(*xs)

    def jax_f(*diff):
        xs = [jnp.asarray(a) for a in inputs]
        for i, d in zip(float_at, diff):
            xs[i] = d
        return tuple(_flat(call(ref, xs)))

    want, vjp = jax.vjp(jax_f, *[jnp.asarray(inputs[i]) for i in float_at])
    cots = [rnd(*np.shape(w), seed=seed + j) for j, w in enumerate(want)]
    want_grads = vjp(tuple(jnp.asarray(c) for c in cots))

    xs = [torch.tensor(np.asarray(a)) for a in inputs]
    for i in float_at:
        xs[i].requires_grad_(True)
    got = _flat(call(port, xs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)
    total = sum((g * torch.tensor(c)).sum() for g, c in zip(got, cots)
                if g.requires_grad)
    if torch.is_tensor(total):
        total.backward()
    for i, w in zip(float_at, want_grads):
        g = xs[i].grad
        g = torch.zeros_like(xs[i]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def both(name, *args, port_kw=None, **kw):
    return (getattr(jnn, name)(*args, **kw),
            getattr(pnn, name)(*args, **kw, **(port_kw or {})))


# ---- nn/activation.py: all 35 classes ---------------------------------

ACTIVATIONS = [
    ("ReLU", (), rnd), ("ReLU6", (), lambda *s, seed: rnd(*s, seed=seed) * 4),
    ("Tanh", (), rnd), ("Sigmoid", (), rnd), ("HardSigmoid", (), rnd),
    ("HardTanh", (-0.5, 0.8), rnd), ("LeakyReLU", (0.03,), rnd),
    ("PReLU", (7,), rnd), ("PReLU", (0,), rnd), ("RReLU", (0.1, 0.3), rnd),
    ("SReLU", ((7,),), lambda *s, seed: rnd(*s, seed=seed) * 2),
    ("ELU", (0.7,), rnd), ("SoftPlus", (2.0,), rnd), ("SoftSign", (), rnd),
    ("SoftShrink", (0.5,), rnd), ("HardShrink", (0.5,), rnd),
    ("TanhShrink", (), rnd), ("SoftMax", (), rnd), ("SoftMin", (), rnd),
    ("LogSoftMax", (), rnd), ("SoftMax", (0,), rnd), ("LogSigmoid", (), rnd),
    ("Threshold", (0.1, -2.0), rnd), ("BinaryThreshold", (0.2,), rnd),
    ("Clamp", (-1, 1), rnd), ("Power", (2.0, 1.5, 0.1), pos),
    ("Square", (), rnd), ("Sqrt", (), pos), ("Log", (), pos),
    ("Exp", (), rnd), ("Abs", (), rnd), ("Negative", (), rnd),
    ("GradientReversal", (0.7,), rnd), ("AddConstant", (0.7,), rnd),
    ("MulConstant", (2.5,), rnd), ("GELU", (), rnd), ("GELU", (False,), rnd),
    ("Swish", (), rnd),
]


@pytest.mark.parametrize("name,args,make", ACTIVATIONS,
                         ids=[f"{a[0]}{a[1]}" for a in ACTIVATIONS])
def test_activation_matches_reference(name, args, make):
    set_seed(3)
    with_params = name in ("PReLU", "SReLU")
    ref, port = both(name, *args, port_kw=CPU if with_params else None)
    if with_params:
        # move the parameters off their constant initial values
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rnd(*np.shape(a), seed=9) * 0.3,
            ref.parameters())
        ref.load_parameters(jax.tree_util.tree_map(jnp.asarray, params))
        load_jax_parameters(port, params)
    if name == "RReLU":
        ref.eval_mode()
        port.eval()
    check(ref, port, [make(3, 7, seed=len(name))])


def test_activation_module_exports_every_reference_class():
    from bigdl_tpu.nn import activation as ja
    from bigdl_tpu_torch.nn import activation as pa
    assert sorted(pa.__all__) == sorted(ja.__all__)
    assert {a[0] for a in ACTIVATIONS} == set(ja.__all__)


def test_rrelu_trains_on_the_generator_in_scope():
    from bigdl_tpu_torch.core.module import forward_context
    m = pnn.RReLU(0.1, 0.3)
    x = -torch.ones(1000)
    with forward_context(generator=torch.Generator().manual_seed(1)):
        a = m(x)
    with forward_context(generator=torch.Generator().manual_seed(1)):
        b = m(x)
    assert torch.equal(a, b)
    assert 0.1 <= float(-a.max()) and float(-a.min()) <= 0.3
    assert float(a.std()) > 0.03


# ---- nn/shape_ops.py: all 26 classes ----------------------------------

def _masked(seed):
    x = rnd(2, 3, 4, seed=seed)
    x[0, 1] = 0.0
    x[1, 2] = 0.0
    return x


SHAPE_OPS = [
    ("Reshape", ((4, 6),), {}, [rnd(2, 24)], False),
    ("Reshape", ((28, 28, 1),), dict(batch_mode=True), [rnd(2, 784)], False),
    ("Reshape", ((4, 6),), {}, [rnd(24)], False),
    ("Flatten", (), {}, [rnd(2, 3, 4, 5)], False),
    ("View", (12,), {}, [rnd(2, 3, 4)], False),
    ("View", (-1, 2), {}, [rnd(2, 3, 4)], False),
    ("Squeeze", (2, 2), {}, [rnd(3, 4, 1)], False),
    ("Squeeze", (), {}, [rnd(2, 1, 3, 1)], False),
    ("Unsqueeze", (2, 2), {}, [rnd(3, 4, 5)], False),
    ("Transpose", (((1, 2), (2, 3)),), {}, [rnd(2, 3, 4)], False),
    ("Select", (2, 3), {}, [rnd(2, 4, 5)], False),
    ("Select", (-1, -2), {}, [rnd(2, 4, 5)], False),
    ("Narrow", (2, 2, 3), {}, [rnd(2, 6, 3)], False),
    ("Narrow", (2, 2, -2), {}, [rnd(2, 6, 3)], False),
    ("Replicate", (3, 2), {}, [rnd(2, 4)], False),
    ("Padding", (2, -2, 2), dict(value=1.5), [rnd(3, 4, 5)], False),
    ("Padding", (1, 3, 2), {}, [rnd(4, 5)], False),
    ("SpatialZeroPadding", (1, 2, 3, 0), {}, [rnd(2, 4, 5, 3)], False),
    ("SpatialZeroPadding", (1, 2, 3, 0), dict(data_format="NCHW"),
     [rnd(2, 3, 4, 5)], False),
    ("Cropping2D", ((1, 0), (2, 1)), {}, [rnd(2, 6, 7, 3)], False),
    ("Cropping2D", ((1, 2), (0, 1)), dict(data_format="NCHW"),
     [rnd(2, 3, 6, 7)], False),
    ("Cropping3D", ((1, 0), (0, 1), (1, 1)), {}, [rnd(2, 4, 5, 6, 3)],
     False),
    ("Tile", (2, 3), {}, [rnd(2, 3, 4)], False),
    ("ExpandSize", ((2, -1, 4),), {}, [rnd(2, 3, 1)], False),
    ("InferReshape", ((0, -1, 2),), dict(batch_mode=True),
     [rnd(2, 3, 4, 2)], False),
    ("InferReshape", ((-1, 4),), {}, [rnd(2, 3, 4)], False),
    ("Contiguous", (), {}, [rnd(2, 3)], False),
    ("Index", (2,), {}, [rnd(3, 5, 4), np.array([[1, 3], [5, 2]])], True),
    ("MaskedSelect", (), {},
     [rnd(3, 4), rnd(3, 4, seed=8) > 0], True),
    ("Max", (2, 2), {}, [rnd(3, 4, 5)], False),
    ("Min", (1,), {}, [rnd(4, 5)], False),
    ("Mean", (2, 2), dict(squeeze=False), [rnd(3, 4, 5)], False),
    ("Sum", (2,), dict(size_average=True), [rnd(3, 4)], False),
    ("Sum", (1,), {}, [rnd(3, 4)], False),
    ("Masking", (0.0,), {}, [_masked(3)], False),
    ("Pack", (2,), {}, [rnd(2, 3), rnd(2, 3, seed=1), rnd(2, 3, seed=2)],
     True),
    ("Reverse", (2,), {}, [rnd(2, 5, 3)], False),
]


@pytest.mark.parametrize("name,args,kw,inputs,table", SHAPE_OPS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPE_OPS)])
def test_shape_op_matches_reference(name, args, kw, inputs, table):
    ref, port = both(name, *args, **kw)
    check(ref, port, inputs, table=table)


def test_shape_ops_module_exports_every_reference_class():
    from bigdl_tpu.nn import shape_ops as js
    from bigdl_tpu_torch.nn import shape_ops as ps
    assert sorted(ps.__all__) == sorted(js.__all__)
    assert {c[0] for c in SHAPE_OPS} == set(js.__all__)


# ---- nn/containers.py -------------------------------------------------

def _linear(m, i, o):
    if m is jnn:
        return jnn.Linear(i, o)
    return pnn.Linear(i, o, generator=torch.Generator(), **CPU)


def _graph_two_inputs(m):
    a, b = m.Input(), m.Input()
    la = _linear(m, 4, 3)(a)
    lb = _linear(m, 5, 3)(b)
    return m.Graph([a, b], m.Pack(2)(la, m.Tanh()(lb)))


def _graph_two_outputs(m):
    a = m.Input()
    h = m.Tanh()(_linear(m, 4, 6)(a))
    return m.Graph(a, [_linear(m, 6, 2)(h), m.Sigmoid()(h)])


CONTAINERS = [
    ("Sequential", lambda m: m.Sequential(_linear(m, 4, 5), m.Tanh(),
                                          _linear(m, 5, 3)),
     [rnd(2, 4)], False),
    ("Concat", lambda m: m.Concat(2, _linear(m, 4, 3), _linear(m, 4, 2)),
     [rnd(2, 4)], False),
    ("ConcatTable", lambda m: m.ConcatTable(_linear(m, 4, 3), m.Tanh()),
     [rnd(2, 4)], False),
    ("ParallelTable", lambda m: m.ParallelTable(_linear(m, 4, 3), m.Tanh()),
     [rnd(2, 4), rnd(2, 5, seed=1)], True),
    ("MapTable", lambda m: m.MapTable(_linear(m, 4, 3)),
     [rnd(2, 4), rnd(2, 4, seed=1)], True),
    ("Bottle", lambda m: m.Bottle(_linear(m, 4, 3), 2, 2),
     [rnd(2, 3, 4)], False),
    ("Graph_two_inputs", _graph_two_inputs,
     [rnd(2, 4), rnd(2, 5, seed=1)], True),
    ("Graph_two_outputs", _graph_two_outputs, [rnd(2, 4)], False),
    ("Sequential_of_Concat", lambda m: m.Sequential(
        m.Concat(2, m.Sequential(_linear(m, 4, 3), m.ReLU()),
                 _linear(m, 4, 2)), _linear(m, 5, 2), m.LogSoftMax()),
     [rnd(2, 4)], False),
]


@pytest.mark.parametrize("name,make,inputs,table", CONTAINERS,
                         ids=[c[0] for c in CONTAINERS])
def test_container_matches_reference(name, make, inputs, table):
    set_seed(4)
    ref, port = make(jnn), make(pnn)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    check(ref, port, inputs, table=table, tol=CONTAINER_TOL)


def test_graph_topological_order_and_refusals():
    a = pnn.Input()
    x = pnn.Tanh().set_name("t")(a)
    y = pnn.Sigmoid()(x)
    g = pnn.Graph(a, [y, x])
    assert [m.name for m in g.graph_modules] == ["t", "Sigmoid"]
    with pytest.raises(ValueError, match="expects 1 input"):
        g(torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="not connected"):
        pnn.Graph([a, pnn.Input()], y)
    seq = pnn.Sequential().add(pnn.Tanh()).add(pnn.ReLU())
    assert len(seq) == 2 and isinstance(seq[1], pnn.ReLU)


# ---- nn/pooling.py: the average pools ---------------------------------

POOLS = [
    ("SpatialAveragePooling", (2, 2, 2, 2), {}, (2, 8, 8, 3)),
    ("SpatialAveragePooling", (3, 3, 2, 2, 1, 1), {}, (2, 9, 10, 3)),
    ("SpatialAveragePooling", (3, 3, 2, 2, 1, 1),
     dict(count_include_pad=False), (2, 9, 10, 3)),
    ("SpatialAveragePooling", (3, 3, 2, 2), dict(ceil_mode=True),
     (2, 8, 9, 3)),
    ("SpatialAveragePooling", (2, 3, 1, 2), dict(divide=False),
     (2, 7, 6, 2)),
    ("SpatialAveragePooling", (1, 1), dict(global_pooling=True),
     (2, 5, 6, 4)),
    ("SpatialAveragePooling", (3, 3, 2, 2, -1, -1), {}, (2, 7, 9, 3)),
    ("SpatialAveragePooling", (2, 2, 2, 2), dict(data_format="NCHW"),
     (2, 3, 8, 6)),
    ("GlobalAveragePooling2D", (), {}, (2, 5, 6, 4)),
    ("GlobalAveragePooling2D", (), dict(data_format="NCHW"), (2, 4, 5, 6)),
]


@pytest.mark.parametrize("name,args,kw,shape", POOLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(POOLS)])
def test_average_pooling_matches_reference(name, args, kw, shape):
    ref, port = both(name, *args, **kw)
    check(ref, port, [rnd(*shape, seed=5)])
