"""The port's ``ops/operations.py`` and ``ops/feature_columns.py`` against
the JAX package's, on the CPU.

Restates ``tests/test_operations.py`` whole (its TF-import cases are
ROADMAP.md queue 1, item 13), each op on the same numpy inputs in both
packages, with the edges where torch's function differs from the JAX one
the reference calls: floor and truncating division and remainders on
negative operands, half-to-even rounding, a one-hot index out of range,
a bucket boundary, top-k ties, a NaN target in InTopK, gathers and
segment ids out of range, SAME dilation's padding.  Every name of the
reference's ``operations.__all__`` is held here (``test_every_operation
_is_held``).  The random ops cannot match JAX's draws across RNGs: they
are held by their bounds, their first two moments (within 5 standard
errors over 20000 draws) and their determinism under one generator.

Tolerance: float32 rtol 1e-6, atol 1e-6 where both packages compute the
same formula; the special functions rtol 2e-6 (``Erf``/``Erfc``),
1e-5 (``Lgamma``) and 1e-5 (``Digamma``), torch's and XLA's float32
approximations being some ulps apart; the convolutions and products
rtol 1e-5, atol 1e-6.  Integer, boolean and index results are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import ops as jops
from bigdl_tpu.core.module import forward_context as jforward_context
from bigdl_tpu.nn.sparse import SparseTensor as JSparse
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import ops as pops
from bigdl_tpu_torch.core.module import forward_context
from bigdl_tpu_torch.nn.sparse import SparseTensor as PSparse

from test_torch_rnn import one_torch_thread, rnd  # noqa: F401

EXACT = dict(rtol=0, atol=0)
F32 = dict(rtol=1e-6, atol=1e-6)
PROD = dict(rtol=1e-5, atol=1e-6)

HALVES = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7, -3.7, 0.0],
                    np.float32)
INT_A = np.asarray([7, -7, 7, -7, 6, -6, 0, 1], np.int32)
INT_B = np.asarray([2, 2, -2, -2, 3, 4, 3, -5], np.int32)
FLT_A = np.asarray([7.5, -7.5, 7.5, -7.5, 6.0, -0.25, 0.0, 1e-3],
                   np.float32)
FLT_B = np.asarray([2.0, 2.0, -2.0, -2.0, 3.0, 4.0, 3.0, -5.0], np.float32)
X34 = rnd(3, 4, seed=1)
POS = np.abs(rnd(7, seed=2)) + 0.25


def _to(side, v):
    """numpy arrays of a (nested) op input to the side's tensors."""
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if side == "jax" else torch.tensor(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_to(side, a) for a in v)
    return v


def _np(y):
    if isinstance(y, (tuple, list)):
        return [_np(a) for a in y]
    if torch.is_tensor(y):
        return y.detach().numpy()
    return np.asarray(y)


# (case id, make(ops module), input, tolerance)
CASES = [
    ("All", lambda m: m.All(), (X34 > -1, 0), EXACT),
    ("All_keep", lambda m: m.All(keep_dims=True), (X34 > 0, [0, 1]), EXACT),
    ("Any", lambda m: m.Any(), (X34 > 1, None), EXACT),
    ("Any_keep", lambda m: m.Any(keep_dims=True), (X34 > 1, 1), EXACT),
    ("ArgMax_ties", lambda m: m.ArgMax(1),
     np.asarray([[1, 3, 3], [2, 2, 1]], np.float32), EXACT),
    ("BatchMatMul", lambda m: m.BatchMatMul(),
     (rnd(2, 3, 4, seed=3), rnd(2, 4, 5, seed=4)), PROD),
    ("BatchMatMul_adj", lambda m: m.BatchMatMul(True, True),
     (rnd(2, 4, 3, seed=5), rnd(2, 5, 4, seed=6)), PROD),
    ("Cast", lambda m: m.Cast(np.int32), HALVES * 1.3, EXACT),
    ("Ceil", lambda m: m.Ceil(), HALVES, EXACT),
    ("Floor", lambda m: m.Floor(), HALVES, EXACT),
    ("Round_half_even", lambda m: m.Round(), HALVES, EXACT),
    ("Rint_half_even", lambda m: m.Rint(), HALVES, EXACT),
    ("Equal", lambda m: m.Equal(), (INT_A, INT_B), EXACT),
    ("NotEqual", lambda m: m.NotEqual(), (INT_A, INT_B), EXACT),
    ("Greater", lambda m: m.Greater(), (INT_A, INT_B), EXACT),
    ("GreaterEqual", lambda m: m.GreaterEqual(), (INT_A, INT_B), EXACT),
    ("Less", lambda m: m.Less(), (INT_A, INT_B), EXACT),
    ("LessEqual", lambda m: m.LessEqual(), (FLT_A, FLT_B), EXACT),
    ("Erf", lambda m: m.Erf(), X34 * 2, dict(rtol=2e-6, atol=1e-7)),
    ("Erfc", lambda m: m.Erfc(), X34 * 2, dict(rtol=2e-6, atol=1e-7)),
    ("Expm1", lambda m: m.Expm1(), X34, F32),
    ("FloorDiv_int", lambda m: m.FloorDiv(), (INT_A, INT_B), EXACT),
    ("FloorDiv_float", lambda m: m.FloorDiv(), (FLT_A, FLT_B), EXACT),
    ("FloorMod_int", lambda m: m.FloorMod(), (INT_A, INT_B), EXACT),
    ("FloorMod_float", lambda m: m.FloorMod(), (FLT_A, FLT_B), F32),
    ("Mod_int", lambda m: m.Mod(), (INT_A, INT_B), EXACT),
    ("Mod_float", lambda m: m.Mod(), (FLT_A, FLT_B), EXACT),
    ("TruncateDiv_int", lambda m: m.TruncateDiv(), (INT_A, INT_B), EXACT),
    ("TruncateDiv_float", lambda m: m.TruncateDiv(), (FLT_A, FLT_B), EXACT),
    ("Inv", lambda m: m.Inv(), POS, F32),
    ("IsFinite", lambda m: m.IsFinite(),
     np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32), EXACT),
    ("IsInf", lambda m: m.IsInf(),
     np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32), EXACT),
    ("IsNan", lambda m: m.IsNan(),
     np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32), EXACT),
    ("L2Loss", lambda m: m.L2Loss(), X34, F32),
    ("Lgamma", lambda m: m.Lgamma(), POS * 3, dict(rtol=1e-5, atol=1e-6)),
    ("Digamma", lambda m: m.Digamma(), POS * 3, dict(rtol=1e-5, atol=1e-6)),
    ("Log1p", lambda m: m.Log1p(), POS, F32),
    ("LogicalAnd", lambda m: m.LogicalAnd(), (X34 > 0, X34 > 0.5), EXACT),
    ("LogicalOr", lambda m: m.LogicalOr(), (X34 > 0, X34 < -0.5), EXACT),
    ("LogicalNot", lambda m: m.LogicalNot(), X34 > 0, EXACT),
    ("MaximumOp", lambda m: m.MaximumOp(), (FLT_A, FLT_B), EXACT),
    ("MinimumOp", lambda m: m.MinimumOp(), (FLT_A, FLT_B), EXACT),
    ("Maximum", lambda m: m.Maximum(), (INT_A, INT_B), EXACT),
    ("Minimum", lambda m: m.Minimum(), (INT_A, INT_B), EXACT),
    ("OneHot_out_of_range", lambda m: m.OneHot(),
     (np.asarray([-1, 0, 2, 5], np.int32), 3, 5.0, -1.0), EXACT),
    ("OneHot_axis0", lambda m: m.OneHot(axis=0),
     (np.asarray([[0, 2], [1, 3]], np.int32), 3), EXACT),
    ("Pad_constant", lambda m: m.Pad(constant_value=2.5),
     (rnd(2, 3, 4, seed=7), [[1, 0], [0, 2], [1, 1]]), EXACT),
    ("Pad_reflect", lambda m: m.Pad("REFLECT"),
     (rnd(3, 4, 5, seed=8), [[1, 2], [2, 1], [0, 3]]), EXACT),
    ("Pad_symmetric", lambda m: m.Pad("SYMMETRIC"),
     (rnd(3, 4, seed=9), [[3, 1], [2, 4]]), EXACT),
    ("Pow", lambda m: m.Pow(), (POS, rnd(7, seed=10)), F32),
    ("Prod", lambda m: m.Prod(axis=1, keep_dims=True), X34, F32),
    ("Rank", lambda m: m.Rank(), rnd(2, 3, 4, seed=11), EXACT),
    ("RangeOps_int", lambda m: m.RangeOps() if m is jops
     else m.RangeOps(device="cpu"), (1, 7, 2), EXACT),
    ("RangeOps_float", lambda m: m.RangeOps() if m is jops
     else m.RangeOps(device="cpu"), (0.5, 3.0, 0.75), EXACT),
    ("Rsqrt", lambda m: m.Rsqrt(), POS, F32),
    ("SelectOp", lambda m: m.SelectOp(), (X34 > 0, X34, -X34), EXACT),
    ("Sign", lambda m: m.Sign(),
     np.asarray([-2.0, -0.0, 0.0, 3.0, np.nan], np.float32), EXACT),
    ("Sign_int", lambda m: m.Sign(), INT_A, EXACT),
    ("Slice", lambda m: m.Slice((0, 1, 0), (2, 2, -1)),
     rnd(2, 3, 4, seed=12), EXACT),
    ("SquaredDifference", lambda m: m.SquaredDifference(), (FLT_A, FLT_B),
     EXACT),
    ("SumOp_axes", lambda m: m.SumOp(), (rnd(2, 3, 4, seed=13), [0, 2]), F32),
    ("SumOp_all_keep", lambda m: m.SumOp(keep_dims=True), (X34, None), F32),
    ("TileOp", lambda m: m.TileOp(), (X34, [2, 1]), EXACT),
    ("TileOp_lead", lambda m: m.TileOp(), (rnd(3, seed=14), [2, 2]), EXACT),
    ("TopK_ties", lambda m: m.TopK(3),
     np.asarray([[1.0, 5.0, 3.0, 5.0, 3.0], [2.0, 2.0, 2.0, 2.0, 1.0]],
                np.float32), EXACT),
    ("BucketizedCol_boundaries", lambda m: m.BucketizedCol([10.0, 0.0, 100.0]),
     np.asarray([-5.0, 0.0, 5.0, 10.0, 50.0, 100.0, 500.0], np.float32), EXACT),
    ("BucketizedCol_int", lambda m: m.BucketizedCol([0.5, 2.0]),
     np.asarray([0, 1, 2, 3], np.int32), EXACT),
    ("CrossEntropy", lambda m: m.CrossEntropy(),
     (rnd(3, 5, seed=15), np.eye(5, dtype=np.float32)[[1, 4, 0]]), F32),
    ("DepthwiseConv2D_same", lambda m: m.DepthwiseConv2D(2, 2, "SAME"),
     (rnd(2, 7, 6, 3, seed=16), rnd(3, 3, 3, 2, seed=17)), PROD),
    ("DepthwiseConv2D_valid", lambda m: m.DepthwiseConv2D(1, 2, "VALID"),
     (rnd(1, 6, 6, 3, seed=18), rnd(2, 3, 3, 2, seed=19)), PROD),
    ("TensorOp_chain", lambda m: (m.TensorOp() * 2.0 + 2.0).abs().sqrt(),
     X34, F32),
    ("TensorOp_ops", lambda m: (m.TensorOp(lambda v: v * 3.0)
                                - m.TensorOp().exp()) / 2.0,
     X34, F32),
    ("TensorOp_reduce", lambda m: m.TensorOp().relu().sum(axis=1), X34, F32),
    ("TensorOp_methods", lambda m: (m.TensorOp().sigmoid().log().negative()
                                    .square().rsqrt().inv().floor().ceil()),
     X34, F32),
    ("TensorOp_acts", lambda m: (m.TensorOp().tanh() ** 2).elu().softplus()
     .softsign().log1p().clamp(0.1, 0.5).mean(axis=0, keepdims=True).t(),
     X34, F32),
    ("TensorOp_softmax", lambda m: m.TensorOp().softmax().exp(), X34, F32),
    ("ApproximateEqual", lambda m: m.ApproximateEqual(0.1),
     (np.asarray([1.0, 2.0, 3.0], np.float32),
      np.asarray([1.05, 3.0, 2.95], np.float32)), EXACT),
    ("Gather_wrap_and_fill", lambda m: m.Gather(),
     (rnd(3, 2, seed=20), np.asarray([2, -1, 0, 3, -4, 1], np.int32)),
     EXACT),
    ("InTopK_ties", lambda m: m.InTopK(2),
     (np.asarray([[0.5, 0.5, 0.5, 0.1], [0.9, 0.2, 0.2, 0.2],
                  [np.nan, 0.5, 0.1, 0.0]], np.float32),
      np.asarray([2, 3, 0], np.int32)), EXACT),
    ("InTopK_from_1", lambda m: m.InTopK(1, start_from_1=True),
     (np.asarray([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32),
      np.asarray([2, 0], np.int32)), EXACT),
    ("SegmentSum", lambda m: m.SegmentSum(),
     (rnd(5, 2, seed=21), np.asarray([0, 0, 1, 3, 3], np.int32)), F32),
    ("SegmentSum_static_drop", lambda m: m.SegmentSum(num_segments=2),
     (rnd(4, 3, seed=22), np.asarray([0, 1, 1, 2], np.int32)), F32),
    ("ModuleToOperation", lambda m: m.ModuleToOperation(
        (jnn if m is jops else pnn).ReLU()), X34, EXACT),
    ("Dilation2D_valid", lambda m: m.Dilation2D((1, 1, 1, 1), (1, 1, 1, 1)),
     (np.arange(32, dtype=np.float32).reshape(1, 4, 4, 2),
      rnd(2, 2, 2, seed=23)), EXACT),
    ("Dilation2D_same_strided", lambda m: m.Dilation2D(
        (1, 2, 2, 1), (1, 2, 1, 1), "SAME"),
     (rnd(2, 7, 6, 3, seed=24), rnd(2, 3, 3, seed=25)), EXACT),
    ("Dilation2D_same_int", lambda m: m.Dilation2D(
        (1, 1, 1, 1), (1, 1, 1, 1), "SAME"),
     (np.full((1, 3, 3, 1), -5, np.int32), np.zeros((2, 2, 1), np.int32)),
     EXACT),
]


@pytest.mark.parametrize("name,make,x,tol", CASES, ids=[c[0] for c in CASES])
def test_operation_matches_reference(name, make, x, tol):
    want = _np(make(jops)(_to("jax", x)))
    got = _np(make(pops)(_to("torch", x)))
    if isinstance(want, list):
        assert len(got) == len(want)
    else:
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), **tol)


def test_operations_edges_by_hand():
    """tests/test_operations.py's hand-made expectations, on the port."""
    assert pops.TruncateDiv()((torch.tensor([-7]), torch.tensor([2]))) \
        .tolist() == [-3]
    assert pops.FloorDiv()((torch.tensor([-7]), torch.tensor([2]))) \
        .tolist() == [-4]
    assert pops.Mod()((torch.tensor([-7]), torch.tensor([2]))).tolist() \
        == [-1]
    assert pops.FloorMod()((torch.tensor([-7]), torch.tensor([2]))) \
        .tolist() == [1]
    assert pops.Round()(torch.tensor([0.5, 1.5, 2.5])).tolist() \
        == [0.0, 2.0, 2.0]
    v, i = pops.TopK(2)(torch.tensor([1.0, 5.0, 3.0, 5.0]))
    assert v.tolist() == [5.0, 5.0] and i.tolist() == [1, 3]
    assert pops.Cast(torch.int32)(torch.tensor([1.7])).dtype == torch.int32
    assert pops.Substr()((np.asarray(b"hello", object), 1, 3)) == b"ell"
    assert pops.Rank()(torch.zeros(2, 3, device="meta")).device.type == \
        "meta"


def test_range_ops_makes_its_range_on_the_card_by_default(monkeypatch):
    """RangeOps' inputs are numbers: its device is its own, the card
    unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pops.RangeOps()
    assert pops.RangeOps(device="cpu")((0, 3, 1)).tolist() == [0, 1, 2]
    assert pops.Maximum is pops.MaximumOp and pops.Minimum is pops.MinimumOp
    assert pops.Compare is pops.operations._Binary
    with pytest.raises(ValueError, match="out of range"):
        pops.Substr()((np.asarray([b"hi"], object), 5, 2))
    with pytest.raises(ValueError, match="out of range"):
        pops.Substr()((np.asarray(b"hello", object), -2, 2))
    with pytest.raises(ValueError, match="pad mode"):
        pops.Pad("EDGE")


def test_substr_matches_reference():
    arr = np.asarray([[b"hello", b"world"], [b"abc", b"xy"]], object)
    want = jops.Substr()((arr, 1, 3))
    got = pops.Substr()((arr, 1, 3))
    assert got.tolist() == want.tolist()


# ---- the random ops --------------------------------------------------------------

def test_random_ops_need_a_generator_and_repeat_under_one():
    with pytest.raises(RuntimeError, match="No RNG"):
        pops.RandomUniform()(np.asarray([2, 2]))
    with pytest.raises(RuntimeError, match="No RNG"):
        pops.TruncatedNormal()(np.asarray([2]))
    draws = []
    for _ in range(2):
        with forward_context(generator=torch.Generator().manual_seed(0)):
            draws.append((pops.RandomUniform(0.0, 1.0)(np.asarray([4])),
                          pops.TruncatedNormal()(np.asarray([3]))))
    for a, b in zip(*draws):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op,lo,hi,mean,var", [
    ("uniform", -2.0, 3.0, 0.5, 25.0 / 12.0),
    # N(1, 2^2) truncated at two standard deviations: variance
    # 4 * (1 - 4 phi(2) / (Phi(2) - Phi(-2)))
    ("truncated", -3.0, 5.0, 1.0, 4.0 * (1.0 - 4.0 * 0.05399096651318806
                                          / 0.9544997361036416)),
])
def test_random_ops_bounds_and_moments_as_the_reference(op, lo, hi, mean,
                                                        var):
    n = 20000
    shape = np.asarray([n])
    make = {"uniform": lambda m: m.RandomUniform(-2.0, 3.0),
            "truncated": lambda m: m.TruncatedNormal(1.0, 2.0)}[op]
    with forward_context(generator=torch.Generator().manual_seed(3)):
        got = make(pops)(shape).numpy().astype(np.float64)
    with jforward_context(rng=jax.random.key(3)):
        ref = np.asarray(make(jops)(shape)).astype(np.float64)
    for x in (got, ref):
        assert x.shape == (n,) and x.min() >= lo and x.max() <= hi
        se = np.sqrt(var / n)
        assert abs(x.mean() - mean) < 5 * se
        assert abs(x.var() - var) < 5 * var * np.sqrt(2.0 / n) * 1.5


# ---- feature columns ----------------------------------------------------------------

def _sp_equal(got, want):
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))


FEATURES = np.asarray(["apple", "pear,plum", "", "ünïcödé,a,b,c",
                       "a very long feature string past the 32-bit wrap"],
                      dtype=object)


def test_java_string_hash_is_the_reference_copy():
    from bigdl_tpu.ops.feature_columns import java_string_hash as jh
    from bigdl_tpu_torch.ops.feature_columns import java_string_hash as ph
    for s in list(FEATURES) + ["", "u1_x", "\x00￿"]:
        assert ph(s) == jh(s)
    # Java's String.hashCode: "abc" -> 96354, signed 32-bit wrap
    assert ph("abc") == 96354 and ph("polygenelubricants") == -2147483648


@pytest.mark.parametrize("is_sparse", [True, False])
def test_hash_bucket_matches_reference(is_sparse):
    """test_operations.py:162: deterministic, 1-based, 0 the padding;
    multi-value features split."""
    want = jops.CategoricalColHashBucket(100, is_sparse=is_sparse)(FEATURES)
    got = pops.CategoricalColHashBucket(100, is_sparse=is_sparse)(FEATURES)
    if is_sparse:
        _sp_equal(got, want)
        assert isinstance(got, PSparse)
    else:
        np.testing.assert_array_equal(got, want)
        assert got[2, 0] == 0


def test_vocabulary_list_and_cross_col_match_reference():
    vl = ["a", "b"]
    x = np.asarray(["a", "b,zzz", "", "b,a"], dtype=object)
    _sp_equal(pops.CategoricalColVocaList(vl, is_set_default=True)(x),
              jops.CategoricalColVocaList(vl, is_set_default=True)(x))
    np.testing.assert_array_equal(
        pops.CategoricalColVocaList(vl, is_set_default=True,
                                    is_sparse=False)(x),
        jops.CategoricalColVocaList(vl, is_set_default=True,
                                    is_sparse=False)(x))
    with pytest.raises(ValueError, match="vocabulary"):
        pops.CategoricalColVocaList(["a"])(np.asarray(["q"], dtype=object))
    cols = [np.asarray(["u1", "u2", "u3,u4"], dtype=object),
            np.asarray(["x,y", "x", "z"], dtype=object)]
    _sp_equal(pops.CrossCol(50)(cols), jops.CrossCol(50)(cols))


def test_indicator_mkstring_kv2tensor_match_reference():
    x = np.asarray(["a", "b,zzz", "b,b"], dtype=object)
    jsp = jops.CategoricalColVocaList(["a", "b"], is_set_default=True)(x)
    psp = pops.CategoricalColVocaList(["a", "b"], is_set_default=True)(x)
    for count in (True, False):
        np.testing.assert_array_equal(pops.IndicatorCol(5, count)(psp),
                                      jops.IndicatorCol(5, count)(jsp))
    assert pops.MkString()(psp).tolist() == jops.MkString()(jsp).tolist()
    # padding entries of a fixed-capacity SparseTensor are skipped
    idx, vals = np.asarray([[0, 0], [0, 0]], np.int32), \
        np.asarray([3, 0], np.int32)
    np.testing.assert_array_equal(
        pops.IndicatorCol(5)(PSparse(idx, vals, (1, 4))),
        jops.IndicatorCol(5)(JSparse(idx, vals, (1, 4))))
    assert pops.MkString()(PSparse(idx, vals, (1, 4))).tolist() == ["3"]
    kv = np.asarray(["0:1.5,2:3.0", "1:2.0", "", "0:1.0,0:2.0"],
                    dtype=object)
    np.testing.assert_array_equal(pops.Kv2Tensor()((kv, 4)),
                                  jops.Kv2Tensor()((kv, 4)))
    sp = pops.Kv2Tensor(trans_type=1)((kv, 4))
    _sp_equal(sp, jops.Kv2Tensor(trans_type=1)((kv, 4)))
    np.testing.assert_array_equal(sp.to_dense().numpy(),
                                  pops.Kv2Tensor()((kv, 4)))
    with pytest.raises(ValueError, match="out of range"):
        pops.Kv2Tensor()((np.asarray(["7:1.0"], dtype=object), 4))


def test_feature_columns_feed_lookup_table_sparse():
    """The wide-and-deep input path: hashed ids into LookupTableSparse
    (1-based ids, 0 the padding) on the port's SparseTensor."""
    sp = pops.CategoricalColHashBucket(16)(FEATURES)
    table = pnn.LookupTableSparse(16, 3, combiner="mean",
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    out = table(sp)
    assert out.shape == (5, 3)
    assert torch.all(out[2] == 0)   # the empty feature: padding only
    w = table.weight.detach()
    np.testing.assert_allclose(out[0].detach().numpy(),
                               w[int(sp.values[0]) - 1].numpy(), rtol=1e-6)


# ---- every name --------------------------------------------------------------------

def test_every_operation_is_held():
    """Every name the reference's ops export is in the port, and each
    class of ``operations.__all__`` has a case above (or, for
    ``Operation``, ``Compare``, ``RandomUniform``, ``TruncatedNormal``
    and ``Substr``, a test of its own)."""
    from bigdl_tpu.ops import operations as jo
    from bigdl_tpu_torch.ops import operations as po
    assert sorted(po.__all__) == sorted(jo.__all__)
    assert sorted(pops.__all__) == sorted(jops.__all__)
    from bigdl_tpu.ops import feature_columns as jf
    from bigdl_tpu_torch.ops import feature_columns as pf
    assert sorted(pf.__all__) == sorted(jf.__all__)
    held = {c[0].split("_")[0] for c in CASES}
    own = {"Operation", "Compare", "RandomUniform", "TruncatedNormal",
           "Substr"}
    assert set(jo.__all__) - held - own == set()
    for name in own - {"Operation", "Compare"}:
        assert issubclass(getattr(po, name), po.Operation)
