"""The port's third layer tranche against the JAX package's, on the CPU:
the rest of ``nn/linear.py``, ``nn/pooling.py`` and ``nn/conv.py``, and
``nn/table_ops.py`` whole.  Every class is held forward and backward (the
input's gradient and every parameter's, eager ``jax.vjp``), parameters
and buffers carried across by name (``test_torch_rnn.run_both``); a
table layer runs inside a wrapper on each side that builds its table
from the inputs and flattens a table output into one vector.

Restates the lines of ``tests/test_layers_torch_oracle.py`` and
``tests/test_oracle_sweep_extended.py`` that cover these classes, with
their arguments and input shapes: test_layers_torch_oracle.py :233
(``LookupTable``), :287 (``VolumetricAveragePooling`` without the pad
count), :404-:643 (``Identity``, ``Mul``, ``Add``, ``PairwiseDistance``,
``TemporalMaxPooling``, the volumetric pools, ``UpSampling1D/2D/3D``,
``Bilinear``, ``TemporalConvolution``, ``SpatialSeparableConvolution``,
the ``C*Table``s, ``DotProduct``, ``CosineDistance``, ``MM``,
``JoinTable``, ``MV``, ``Euclidean``, ``Cosine``, ``Maxout``,
``VolumetricFullConvolution``) and test_oracle_sweep_extended.py :354
(``Echo``), :359-:363 (the 3-D global pools), :378 (``Highway``), :401
(``ResizeBilinear`` with ``align_corners``) and :603-:645 (the table
algebra: ``SelectTable``, ``FlattenTable``, ``NarrowTable``,
``SplitTable``, ``BifurcateSplitTable``, ``MixtureTable``,
``CrossProduct``).

Tolerance: float32 rtol 1e-5, atol 1e-6 on outputs and gradients, as
``test_torch_layers_9b.py``.  No case is loosened.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn

from test_torch_rnn import (OUT, assert_run, carry, gen,  # noqa: F401
                            one_torch_thread, rnd, run_both)


def pos(*shape, seed=0):
    return np.abs(rnd(*shape, seed=seed)) + 0.5


def idx(*rows):
    return np.asarray(rows, np.int32)


def _jflat(y):
    if isinstance(y, (tuple, list)):
        return jnp.concatenate([_jflat(t).reshape(-1) for t in y])
    return y


def _pflat(y):
    if isinstance(y, (tuple, list)):
        return torch.cat([_pflat(t).reshape(-1) for t in y])
    return y


class JTable(jnn.Module):
    """The reference's layer on ``pack(inputs)``, a table output
    flattened."""

    def __init__(self, inner, pack):
        super().__init__()
        self.inner = inner
        self.pack = pack

    def forward(self, *xs):
        return _jflat(self.inner(self.pack(list(xs))))


class PTable(pnn.Module):
    """The port's side of :class:`JTable`; every floating input also
    enters the output times 0.0, so an input the layer leaves out (a
    table entry not selected) gets a zero gradient, as ``jax.vjp`` gives
    it, and not none."""

    def __init__(self, inner, pack):
        super().__init__()
        self.inner = inner
        self.pack = pack

    def forward(self, *xs):
        out = _pflat(self.inner(self.pack(list(xs))))
        for x in xs:
            if x.is_floating_point():
                out = out + 0.0 * x.sum()
        return out


def one(xs):
    return xs[0]


def table(xs):
    return tuple(xs)


def hold(name, make, inputs, pack=None, port_kw=None):
    set_seed(sum(map(ord, name)))
    ref = make(jnn, {})
    port = make(pnn, gen(1) if port_kw is None else port_kw)
    if pack is not None:
        ref, port = JTable(ref, pack), PTable(port, pack)
    want, got = run_both(ref, carry(ref, port), inputs)
    assert_run(want, got, out=OUT, grad=OUT)
    assert len(got["dx"]) == len(want["dx"])
    for w, g in zip(want["dx"], got["dx"]):
        np.testing.assert_allclose(g, w, **OUT, err_msg="input gradient")


# ---- nn/linear.py, the rest ----------------------------------------------------

LINEAR = [
    ("Identity", lambda m, k: m.Identity(), lambda: [rnd(3, 7, seed=27)],
     None),
    ("Identity_table", lambda m, k: m.Identity(),
     lambda: [rnd(3, 7, seed=1), rnd(2, 4, seed=2)], table),
    ("Echo", lambda m, k: m.Echo(), lambda: [rnd(3, 4, seed=93)], None),
    ("Bilinear", lambda m, k: m.Bilinear(4, 5, 3, **k),
     lambda: [rnd(6, 4, seed=83), rnd(6, 5, seed=84)], table),
    ("Bilinear_nobias", lambda m, k: m.Bilinear(4, 5, 3, bias_res=False,
                                                **k),
     lambda: [rnd(6, 4, seed=3), rnd(6, 5, seed=4)], table),
    ("Add", lambda m, k: m.Add(7, **k), lambda: [rnd(3, 7, seed=35)], None),
    ("Mul", lambda m, k: m.Mul(**k), lambda: [rnd(3, 7, seed=34)], None),
    ("Cosine", lambda m, k: m.Cosine(4, 3, **k), lambda: [rnd(5, 4, seed=106)],
     None),
    ("Euclidean", lambda m, k: m.Euclidean(4, 3, **k),
     lambda: [rnd(5, 4, seed=105)], None),
    ("Maxout", lambda m, k: m.Maxout(4, 3, 2, **k),
     lambda: [rnd(5, 4, seed=107)], None),
    ("Maxout_nobias", lambda m, k: m.Maxout(6, 2, 3, with_bias=False, **k),
     lambda: [rnd(4, 6, seed=5)], None),
    ("Highway", lambda m, k: m.Highway(5, activation=m.ReLU(), **k),
     lambda: [rnd(4, 5, seed=99)], None),
    ("Highway_linear", lambda m, k: m.Highway(5, **k),
     lambda: [rnd(4, 5, seed=6)], None),
    ("LookupTable", lambda m, k: m.LookupTable(20, 8, **k),
     lambda: [idx([1, 5, 20], [3, 3, 7])], None),
    ("LookupTable_max_norm", lambda m, k: m.LookupTable(
        20, 8, max_norm=1.0, **k), lambda: [idx([1, 5, 20], [3, 3, 7])],
     None),
    ("LookupTable_max_norm_l1", lambda m, k: m.LookupTable(
        12, 4, max_norm=2.0, norm_type=1.0, **k),
     lambda: [idx([1, 12, 2], [6, 0, 13])], None),
    ("LookupTable_mask_zero", lambda m, k: m.LookupTable(
        10, 5, padding_value=3.0, mask_zero=True, **k),
     lambda: [idx([1, 3, 9], [3, 3, 2])], None),
    ("LookupTable_mask_zero_pad0", lambda m, k: m.LookupTable(
        10, 5, mask_zero=True, **k), lambda: [idx([1, 0, 9], [3, 3, 2])],
     None),
]


@pytest.mark.parametrize("name,make,inputs,pack", LINEAR,
                         ids=[c[0] for c in LINEAR])
def test_linear_matches_reference(name, make, inputs, pack):
    hold(name, make, inputs(), pack)


def test_linear_init_weight_and_bias_are_taken_as_given():
    w, b = rnd(3, 4, seed=1), rnd(3, seed=2)
    lin = pnn.Linear(4, 3, init_weight=w, init_bias=b, device="cpu")
    np.testing.assert_array_equal(lin.weight.detach().numpy(), w)
    np.testing.assert_array_equal(lin.bias.detach().numpy(), b)
    with pytest.raises(ValueError, match="generator"):
        pnn.Linear(4, 3, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        pnn.Linear(4, 3, init_weight=w.T, init_bias=b, device="cpu")


# ---- nn/pooling.py, the rest ---------------------------------------------------

POOLING = [
    ("GlobalAveragePooling3D", lambda m, k: m.GlobalAveragePooling3D(),
     lambda: [rnd(2, 4, 4, 4, 3, seed=95)]),
    ("GlobalMaxPooling3D", lambda m, k: m.GlobalMaxPooling3D(),
     lambda: [rnd(2, 4, 4, 4, 3, seed=96)]),
    ("TemporalMaxPooling", lambda m, k: m.TemporalMaxPooling(2),
     lambda: [rnd(2, 8, 4, seed=43)]),
    ("TemporalMaxPooling_overlap", lambda m, k: m.TemporalMaxPooling(3, 2),
     lambda: [rnd(2, 9, 4, seed=7)]),
    ("VolumetricMaxPooling", lambda m, k: m.VolumetricMaxPooling(2, 2, 2),
     lambda: [rnd(2, 4, 6, 6, 2, seed=44)]),
    ("VolumetricMaxPooling_pad", lambda m, k: m.VolumetricMaxPooling(
        3, 3, 3, 2, 2, 2, 1, 1, 1), lambda: [rnd(1, 5, 5, 5, 2, seed=8)]),
    ("VolumetricAveragePooling", lambda m, k: m.VolumetricAveragePooling(
        2, 2, 2), lambda: [rnd(2, 4, 6, 6, 2, seed=45)]),
    ("VolumetricAveragePooling_excl_pad",
     lambda m, k: m.VolumetricAveragePooling(
         2, 2, 2, 2, 2, 2, 1, 1, 1, count_include_pad=False),
     lambda: [rnd(1, 4, 4, 4, 2, seed=0)]),
    ("VolumetricAveragePooling_ceil", lambda m, k: m.VolumetricAveragePooling(
        3, 3, 3, 2, 2, 2, ceil_mode=True, count_include_pad=False),
     lambda: [rnd(1, 6, 6, 6, 2, seed=9)]),
    ("UpSampling1D", lambda m, k: m.UpSampling1D(2),
     lambda: [rnd(2, 5, 3, seed=47)]),
    ("UpSampling2D", lambda m, k: m.UpSampling2D((2, 2)),
     lambda: [rnd(2, 4, 4, 3, seed=48)]),
    ("UpSampling2D_nchw", lambda m, k: m.UpSampling2D((2, 3), "NCHW"),
     lambda: [rnd(2, 3, 4, 4, seed=10)]),
    ("UpSampling3D", lambda m, k: m.UpSampling3D((2, 2, 2)),
     lambda: [rnd(1, 3, 3, 3, 2, seed=49)]),
    ("ResizeBilinear_align", lambda m, k: m.ResizeBilinear(
        7, 9, align_corners=True), lambda: [rnd(2, 4, 5, 3, seed=104)]),
    ("ResizeBilinear_up", lambda m, k: m.ResizeBilinear(7, 9),
     lambda: [rnd(2, 4, 5, 3, seed=11)]),
    ("ResizeBilinear_down", lambda m, k: m.ResizeBilinear(3, 2),
     lambda: [rnd(2, 7, 5, 3, seed=12)]),
    ("ResizeBilinear_nchw", lambda m, k: m.ResizeBilinear(
        5, 3, data_format="NCHW"), lambda: [rnd(2, 3, 4, 6, seed=13)]),
]


@pytest.mark.parametrize("name,make,inputs", POOLING,
                         ids=[c[0] for c in POOLING])
def test_pooling_matches_reference(name, make, inputs):
    hold(name, make, inputs())


# ---- nn/conv.py, the rest ------------------------------------------------------

CONV = [
    ("SpatialSeparableConvolution", lambda m, k:
     m.SpatialSeparableConvolution(3, 6, 2, 3, 3, **k),
     lambda: [rnd(2, 7, 7, 3, seed=87)]),
    ("SpatialSeparableConvolution_same_strided", lambda m, k:
     m.SpatialSeparableConvolution(3, 4, 1, 3, 3, 2, 2, -1, -1, **k),
     lambda: [rnd(2, 8, 8, 3, seed=14)]),
    ("SpatialSeparableConvolution_nchw", lambda m, k:
     m.SpatialSeparableConvolution(2, 3, 2, 3, 3, 1, 1, 1, 1,
                                   data_format="NCHW", **k),
     lambda: [rnd(2, 2, 6, 6, seed=15)]),
    ("TemporalConvolution", lambda m, k: m.TemporalConvolution(4, 6, 3, **k),
     lambda: [rnd(2, 8, 4, seed=85)]),
    ("TemporalConvolution_strided", lambda m, k: m.TemporalConvolution(
        4, 5, 3, 2, **k), lambda: [rnd(2, 9, 4, seed=16)]),
    ("TemporalConvolution_unbatched", lambda m, k: m.TemporalConvolution(
        4, 6, 3, **k), lambda: [rnd(8, 4, seed=17)]),
    ("VolumetricFullConvolution", lambda m, k: m.VolumetricFullConvolution(
        2, 3, 2, 2, 2, 2, 2, 2, **k), lambda: [rnd(1, 3, 4, 4, 2, seed=109)]),
    ("VolumetricFullConvolution_pad_adj", lambda m, k:
     m.VolumetricFullConvolution(2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                 **k), lambda: [rnd(1, 3, 3, 3, 2, seed=18)]),
    ("LocallyConnected2D", lambda m, k: m.LocallyConnected2D(
        3, 6, 5, 4, 3, 3, **k), lambda: [rnd(2, 5, 6, 3, seed=19)]),
    ("LocallyConnected2D_strided_padded", lambda m, k: m.LocallyConnected2D(
        2, 7, 7, 3, 3, 3, 2, 2, 1, 1, **k), lambda: [rnd(2, 7, 7, 2, seed=20)]),
    ("LocallyConnected2D_nchw", lambda m, k: m.LocallyConnected2D(
        2, 5, 5, 3, 2, 2, data_format="NCHW", **k),
     lambda: [rnd(2, 2, 5, 5, seed=21)]),
    ("LocallyConnected1D", lambda m, k: m.LocallyConnected1D(8, 4, 5, 3, **k),
     lambda: [rnd(2, 8, 4, seed=22)]),
    ("LocallyConnected1D_strided", lambda m, k: m.LocallyConnected1D(
        9, 3, 2, 3, 2, **k), lambda: [rnd(2, 9, 3, seed=23)]),
    ("SpatialConvolutionMap_full", lambda m, k: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.full(3, 4), 3, 3, **k),
     lambda: [rnd(2, 6, 6, 3, seed=24)]),
    ("SpatialConvolutionMap_one_to_one", lambda m, k: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.one_to_one(3), 3, 3, 1, 1, 1, 1, **k),
     lambda: [rnd(2, 5, 5, 3, seed=25)]),
    ("SpatialConvolutionMap_random", lambda m, k: m.SpatialConvolutionMap(
        m.SpatialConvolutionMap.random(4, 5, 2, seed=1), 3, 3, 2, 2,
        n_input_plane=4, n_output_plane=5, **k),
     lambda: [rnd(2, 7, 7, 4, seed=26)]),
]


@pytest.mark.parametrize("name,make,inputs", CONV, ids=[c[0] for c in CONV])
def test_conv_matches_reference(name, make, inputs):
    hold(name, make, inputs())


def test_connection_tables_equal_the_reference():
    for args in ((3, 4), ):
        assert pnn.SpatialConvolutionMap.full(*args) \
            == jnn.SpatialConvolutionMap.full(*args)
    assert pnn.SpatialConvolutionMap.one_to_one(5) \
        == jnn.SpatialConvolutionMap.one_to_one(5)
    assert pnn.SpatialConvolutionMap.random(6, 4, 3, seed=7) \
        == jnn.SpatialConvolutionMap.random(6, 4, 3, seed=7)
    with pytest.raises(ValueError, match="beyond"):
        pnn.SpatialConvolutionMap([[3, 1]], 3, 3, n_input_plane=2,
                                  **gen(0))


# ---- nn/table_ops.py -----------------------------------------------------------

TABLES = [
    ("CAddTable", lambda m, k: m.CAddTable(),
     lambda: [rnd(3, 5, seed=61), rnd(3, 5, seed=62)], table),
    ("CAddTable_3", lambda m, k: m.CAddTable(),
     lambda: [rnd(3, 5, seed=1), rnd(3, 5, seed=2), rnd(3, 5, seed=3)],
     table),
    ("CSubTable", lambda m, k: m.CSubTable(),
     lambda: [rnd(3, 5, seed=63), rnd(3, 5, seed=64)], table),
    ("CMulTable", lambda m, k: m.CMulTable(),
     lambda: [rnd(3, 5, seed=65), rnd(3, 5, seed=66)], table),
    ("CDivTable", lambda m, k: m.CDivTable(),
     lambda: [rnd(3, 5, seed=67), pos(3, 5, seed=68)], table),
    ("CMaxTable", lambda m, k: m.CMaxTable(),
     lambda: [rnd(3, 5, seed=69), rnd(3, 5, seed=70)], table),
    ("CMinTable", lambda m, k: m.CMinTable(),
     lambda: [rnd(3, 5, seed=71), rnd(3, 5, seed=72)], table),
    ("CAveTable", lambda m, k: m.CAveTable(),
     lambda: [rnd(3, 5, seed=73), rnd(3, 5, seed=74)], table),
    ("JoinTable", lambda m, k: m.JoinTable(2),
     lambda: [rnd(3, 4, seed=81), rnd(3, 5, seed=82)], table),
    ("JoinTable_batched", lambda m, k: m.JoinTable(1, n_input_dims=1),
     lambda: [rnd(3, 4, seed=4), rnd(3, 2, seed=5)], table),
    ("SplitTable", lambda m, k: m.SplitTable(2),
     lambda: [rnd(3, 4, seed=120)], one),
    ("SplitTable_batched", lambda m, k: m.SplitTable(1, n_input_dims=2),
     lambda: [rnd(2, 3, 4, seed=6)], one),
    ("SplitTable_last", lambda m, k: m.SplitTable(0),
     lambda: [rnd(3, 4, seed=7)], one),
    ("SelectTable", lambda m, k: m.SelectTable(2),
     lambda: [rnd(3, 4, seed=120), rnd(3, 4, seed=121), rnd(3, 4, seed=122)],
     table),
    ("SelectTable_last", lambda m, k: m.SelectTable(-1),
     lambda: [rnd(3, 4, seed=120), rnd(3, 4, seed=121), rnd(3, 4, seed=122)],
     table),
    ("NarrowTable", lambda m, k: m.NarrowTable(2, 2),
     lambda: [rnd(3, 4, seed=120), rnd(3, 4, seed=121), rnd(3, 4, seed=122)],
     table),
    ("NarrowTable_to_end", lambda m, k: m.NarrowTable(1, -1),
     lambda: [rnd(3, 4, seed=8), rnd(2, 4, seed=9), rnd(3, 2, seed=10)],
     table),
    ("FlattenTable", lambda m, k: m.FlattenTable(),
     lambda: [rnd(3, 4, seed=120), rnd(3, 4, seed=121), rnd(3, 4, seed=122)],
     lambda xs: [xs[0], (xs[1], (xs[2],))]),
    ("MixtureTable", lambda m, k: m.MixtureTable(),
     lambda: [rnd(3, 2, seed=123), rnd(3, 4, seed=120), rnd(3, 4, seed=121)],
     lambda xs: [xs[0], (xs[1], xs[2])]),
    ("MixtureTable_tensor", lambda m, k: m.MixtureTable(),
     lambda: [rnd(3, 2, seed=11), rnd(3, 2, 4, seed=12)], table),
    ("DotProduct", lambda m, k: m.DotProduct(),
     lambda: [rnd(3, 5, seed=75), rnd(3, 5, seed=76)], table),
    ("CosineDistance", lambda m, k: m.CosineDistance(),
     lambda: [rnd(3, 5, seed=77), rnd(3, 5, seed=78)], table),
    ("PairwiseDistance", lambda m, k: m.PairwiseDistance(),
     lambda: [rnd(3, 7, seed=38), rnd(3, 7, seed=39)], table),
    ("PairwiseDistance_l1", lambda m, k: m.PairwiseDistance(1),
     lambda: [rnd(3, 7, seed=13), rnd(3, 7, seed=14)], table),
    ("MM", lambda m, k: m.MM(),
     lambda: [rnd(3, 4, 5, seed=79), rnd(3, 5, 6, seed=80)], table),
    ("MM_transposed", lambda m, k: m.MM(True, True),
     lambda: [rnd(3, 5, 4, seed=15), rnd(3, 6, 5, seed=16)], table),
    ("MV", lambda m, k: m.MV(),
     lambda: [rnd(2, 3, 4, seed=103), rnd(2, 4, seed=104)], table),
    ("MV_transposed", lambda m, k: m.MV(True),
     lambda: [rnd(2, 4, 3, seed=17), rnd(2, 4, seed=18)], table),
    ("BifurcateSplitTable", lambda m, k: m.BifurcateSplitTable(2),
     lambda: [rnd(3, 4, seed=120)], one),
    ("BifurcateSplitTable_odd", lambda m, k: m.BifurcateSplitTable(2),
     lambda: [rnd(3, 5, seed=19)], one),
    ("CrossProduct", lambda m, k: m.CrossProduct(),
     lambda: [rnd(3, 4, seed=120), rnd(3, 4, seed=121), rnd(3, 4, seed=122)],
     table),
    ("TableOperation_mul", lambda m, k: m.TableOperation(m.CMulTable()),
     lambda: [rnd(3, 4, seed=20), rnd(3, 1, seed=21)], table),
    ("TableOperation_sub", lambda m, k: m.TableOperation(m.CSubTable()),
     lambda: [rnd(1, 4, seed=22), rnd(3, 4, seed=23)], table),
]


@pytest.mark.parametrize("name,make,inputs,pack", TABLES,
                         ids=[c[0] for c in TABLES])
def test_table_op_matches_reference(name, make, inputs, pack):
    hold(name, make, inputs(), pack, port_kw={})


def test_table_ops_semantics():
    """test_oracle_sweep_extended.py :603-:645 on the port's own: the
    tables' lengths and slices."""
    a, b, c = (torch.tensor(rnd(3, 4, seed=120 + i)) for i in range(3))
    assert torch.equal(pnn.SelectTable(2)([a, b, c]), b)
    assert torch.equal(pnn.SelectTable(-1)([a, b, c]), c)
    flat = pnn.FlattenTable()([a, (b, (c,))])
    assert len(flat) == 3 and torch.equal(flat[2], c)
    nt = pnn.NarrowTable(2, 2)([a, b, c])
    assert len(nt) == 2 and torch.equal(nt[0], b)
    parts = pnn.SplitTable(2)(a)
    assert len(parts) == 4 and torch.equal(parts[1], a[:, 1])
    lo, hi = pnn.BifurcateSplitTable(2)(a)
    assert torch.equal(lo, a[:, :2]) and torch.equal(hi, a[:, 2:])
    x = a.clone().requires_grad_()
    (pnn.CrossProduct()([x, b, c]) ** 2).sum().backward()
    assert torch.isfinite(x.grad).all()


# ---- every reference class exported ---------------------------------------------

def _exports_equal(name):
    import importlib
    ref = importlib.import_module(f"bigdl_tpu.nn.{name}")
    port = importlib.import_module(f"bigdl_tpu_torch.nn.{name}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for n in port.__all__:
        assert hasattr(pnn, n), n


def test_linear_module_exports_every_reference_class():
    _exports_equal("linear")


def test_pooling_module_exports_every_reference_class():
    _exports_equal("pooling")


def test_conv_module_exports_every_reference_class():
    _exports_equal("conv")


def test_quantized_module_exports_every_reference_class():
    _exports_equal("quantized")


def test_table_ops_module_exports_every_reference_class():
    _exports_equal("table_ops")


def test_tree_module_exports_every_reference_class():
    _exports_equal("tree")
