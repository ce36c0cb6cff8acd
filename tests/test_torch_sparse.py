"""The port's ``nn/sparse.py`` against the JAX package's, on the CPU, and
the structural aliases of ``nn/containers.py``.

Restates the sparse section of ``tests/test_sparse_tree_misc.py`` (the
round trip, ``SparseLinear`` against a dense ``Linear``,
``SparseJoinTable``, ``LookupTableSparse``'s combiners and per-id
weights) and ``tests/test_embedding.py`` :119 (``dedup_gather``'s
backward: the naive gradient's values, one combined row per unique id)
and :141 (``LookupTableSparse`` on a duplicate-heavy batch), each against
the reference on the same numpy inputs, parameters carried across.  The
layers are held forward and backward (every parameter's gradient and the
sparse values', eager ``jax.vjp``), through wrappers on each side that
build the SparseTensor from (indices, values) arrays.

Tolerance: float32 rtol 1e-5, atol 1e-6 (``test_torch_rnn.OUT``).
``dedup_gather``'s backward is held bit for bit: the CPU sums each id's
rows left to right in sorted order, as XLA's CPU scatter does.  The
card's order-fixed segmented scan (``segment_scan``) is held here bit for
bit against that sum for runs of up to three rows, and within 1e-6 of a
float64 sum beyond.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.nn.sparse import SparseTensor as JSparse
from bigdl_tpu.nn.sparse import dedup_gather as jdedup_gather
from bigdl_tpu.nn.sparse import dedup_scatter_updates as jdedup_updates
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import sparse as psparse
from bigdl_tpu_torch.nn.sparse import SparseTensor as PSparse

from test_torch_rnn import (OUT, assert_run, carry, gen,  # noqa: F401
                            one_torch_thread, rnd, run_both)


class JS(jnn.Module):
    """The reference's layer on SparseTensors built from (indices,
    values) input pairs of the given shapes; a single one goes in alone,
    several as a table."""

    def __init__(self, inner, shapes, table=False):
        super().__init__()
        self.inner = inner
        self.shapes = tuple(tuple(s) for s in shapes)
        self.table = table

    def forward(self, *xs):
        sps = [JSparse(xs[2 * i], xs[2 * i + 1], s)
               for i, s in enumerate(self.shapes)]
        return self.inner(sps if self.table else
                          (sps[0] if len(sps) == 1 else tuple(sps)))


class PS(pnn.Module):
    """The port's side of :class:`JS`."""

    def __init__(self, inner, shapes, table=False):
        super().__init__()
        self.inner = inner
        self.shapes = tuple(tuple(s) for s in shapes)
        self.table = table

    def forward(self, *xs):
        sps = [PSparse(xs[2 * i], xs[2 * i + 1], s)
               for i, s in enumerate(self.shapes)]
        return self.inner(sps if self.table else
                          (sps[0] if len(sps) == 1 else tuple(sps)))


def coo(dense):
    """(indices int32, values) of a dense array's nonzeros."""
    dense = np.asarray(dense)
    idx = np.argwhere(dense != 0).astype(np.int32)
    return idx, dense[tuple(idx.T)].astype(dense.dtype)


def hold(ref, port, inputs, **kw):
    assert_run(*run_both(ref, carry(ref, port), inputs, jit=True, **kw))


# ---- SparseTensor, DenseToSparse, SparseJoinTable -------------------------------

def test_sparse_roundtrip_matches_reference():
    """test_sparse_tree_misc.py:24: from_dense -> to_dense, and the
    reference's indices for the same input."""
    x = np.asarray([[0.0, 2.0, 0.0], [1.0, 0.0, 3.0]], np.float32)
    jsp = jnn.DenseToSparse()(jnp.asarray(x))
    psp = pnn.DenseToSparse()(torch.tensor(x))
    assert psp.shape == jsp.shape == (2, 3)
    np.testing.assert_array_equal(psp.indices.numpy(),
                                  np.asarray(jsp.indices))
    np.testing.assert_array_equal(psp.values.numpy(), np.asarray(jsp.values))
    np.testing.assert_array_equal(psp.to_dense().numpy(), x)


def test_to_dense_sums_duplicates_and_clips_like_the_reference():
    idx = np.asarray([[0, 1], [0, 1], [1, 7], [-1, 0]], np.int32)
    vals = np.asarray([1.5, 2.0, 3.0, 4.0], np.float32)
    want = np.asarray(JSparse(jnp.asarray(idx), jnp.asarray(vals),
                              (2, 3)).to_dense())
    got = PSparse(idx, vals, (2, 3)).to_dense().numpy()
    np.testing.assert_array_equal(got, want)


def test_sparse_join_table_matches_reference():
    """test_sparse_tree_misc.py:50."""
    a, b = np.asarray([[1.0, 0.0]]), np.asarray([[0.0, 3.0, 4.0]])
    joined = pnn.SparseJoinTable(2)([PSparse.from_dense(torch.tensor(a)),
                                     PSparse.from_dense(torch.tensor(b))])
    jj = jnn.SparseJoinTable(2)([JSparse.from_dense(jnp.asarray(a)),
                                 JSparse.from_dense(jnp.asarray(b))])
    assert joined.shape == jj.shape == (1, 5)
    np.testing.assert_array_equal(joined.indices.numpy(),
                                  np.asarray(jj.indices))
    np.testing.assert_allclose(joined.to_dense().numpy(),
                               [[1.0, 0.0, 0.0, 3.0, 4.0]])


def test_sparse_join_table_forward_and_values_gradient():
    ia, va = coo(rnd(3, 4, seed=1) * (rnd(3, 4, seed=2) > 0))
    ib, vb = coo(rnd(3, 2, seed=3) * (rnd(3, 2, seed=4) > 0))

    class Dense(jnn.Module):
        def forward(self, sps):
            return jnn.SparseJoinTable(2)(sps).to_dense()

    class PDense(pnn.Module):
        def forward(self, sps):
            return pnn.SparseJoinTable(2)(sps).to_dense()

    shapes = [(3, 4), (3, 2)]
    hold(JS(Dense(), shapes, table=True), PS(PDense(), shapes, table=True),
         [ia, va, ib, vb])


# ---- SparseLinear ----------------------------------------------------------

def test_sparse_linear_matches_dense_linear():
    """test_sparse_tree_misc.py:33: the same weights as a dense Linear."""
    layer = pnn.SparseLinear(6, 4, **gen(0))
    x = np.zeros((3, 6), np.float32)
    x[0, 1], x[1, 0], x[2, 5] = 2.0, -1.0, 0.5
    dense = pnn.Linear(6, 4, init_weight=layer.weight.detach(),
                       init_bias=layer.bias.detach(), device="cpu")
    np.testing.assert_allclose(
        layer(PSparse.from_dense(torch.tensor(x))).detach().numpy(),
        dense(torch.tensor(x)).detach().numpy(), **OUT)


@pytest.mark.parametrize("with_bias", [True, False])
def test_sparse_linear_matches_reference(with_bias):
    set_seed(3)
    dense = rnd(5, 7, seed=5) * (rnd(5, 7, seed=6) > 0.3)
    idx, vals = coo(dense)
    hold(JS(jnn.SparseLinear(7, 3, with_bias), [(5, 7)]),
         PS(pnn.SparseLinear(7, 3, with_bias, **gen(1)), [(5, 7)]),
         [idx, vals])


def test_sparse_linear_refuses_a_table():
    layer = pnn.SparseLinear(4, 2, **gen(0))
    sp = PSparse.from_dense(torch.ones(1, 4))
    with pytest.raises(ValueError, match="SparseJoinTable"):
        layer([sp, sp])


# ---- LookupTableSparse ------------------------------------------------------

ID_ROWS = (np.asarray([[0, 0], [0, 1], [1, 0]], np.int32),
           np.asarray([1.0, 3.0, 2.0], np.float32), (2, 2))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_combiners_match_reference(combiner):
    """test_sparse_tree_misc.py:59: row 0 holds ids [1, 3], row 1 id
    [2]."""
    set_seed(1)
    idx, vals, shape = ID_ROWS
    hold(JS(jnn.LookupTableSparse(10, 4, combiner=combiner), [shape]),
         PS(pnn.LookupTableSparse(10, 4, combiner=combiner, **gen(2)),
            [shape]), [idx, vals], grad_inputs=False)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_weights_and_max_norm_match_reference(combiner):
    """test_sparse_tree_misc.py:80 (per-id weights, whose values'
    gradient is held too), with max_norm clipping the gathered rows and
    padding (id 0) entries."""
    set_seed(2)
    rng = np.random.default_rng(7)
    idx = np.asarray([[r, c] for r in range(4) for c in range(3)], np.int32)
    ids = rng.integers(0, 6, size=12).astype(np.float32)   # 0: padding
    wts = (rng.random(12) + 0.5).astype(np.float32)

    def pair(m):
        class W(m.Module):
            def __init__(self, inner):
                super().__init__()
                self.inner = inner

            def forward(self, i, v, w):
                sp = (JSparse if m is jnn else PSparse)
                return self.inner((sp(i, v, (4, 3)), sp(i, w, (4, 3))))
        return W

    kw = dict(combiner=combiner, max_norm=1.5)
    ref = pair(jnn)(jnn.LookupTableSparse(6, 5, **kw))
    port = pair(pnn)(pnn.LookupTableSparse(6, 5, **kw, **gen(3)))
    want, got = run_both(ref, carry(ref, port), [idx, ids, wts],
                         jit=True, grad_inputs=False)
    assert_run(want, got)
    # the weights' gradient, through the port's autograd and jax.vjp
    params, rest = partition(ref)

    def f(w):
        return jnp.sum(combine(params, rest)(jnp.asarray(idx),
                                              jnp.asarray(ids), w) ** 2)
    gw = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(wts)))
    tw = torch.tensor(wts, requires_grad=True)
    (port(torch.tensor(idx), torch.tensor(ids), tw) ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), gw, **OUT)


def test_lookup_table_sparse_duplicate_batch_gradient():
    """test_embedding.py:141: a duplicate-heavy batch (row 0 id 3 three
    times and 7, row 1 id 7 twice and 1 twice): the gradient equals the
    dense gather's and the reference's, untouched rows exactly zero."""
    set_seed(12)
    ref = jnn.LookupTableSparse(16, 4)
    port = carry(ref, pnn.LookupTableSparse(16, 4, **gen(4)))
    dense_ids = np.asarray([[3, 3, 3, 7], [7, 7, 1, 1]], np.int32)
    jsp = JSparse.from_dense(jnp.asarray(dense_ids))
    params, rest = partition(ref)
    g_ref = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(
        combine(p, rest).forward(jsp) ** 2)))(params).weight)
    port.zero_grad()
    (port(PSparse.from_dense(torch.tensor(dense_ids))) ** 2).sum().backward()
    g = port.weight.grad.numpy()
    np.testing.assert_array_equal(g, g_ref)
    w0 = port.weight.detach().clone().requires_grad_()
    (w0[torch.tensor(dense_ids - 1).long()].sum(1) ** 2).sum().backward()
    np.testing.assert_allclose(g, w0.grad.numpy(), **OUT)
    touched = np.zeros(16, bool)
    touched[[0, 2, 6]] = True
    assert np.all(g[~touched] == 0.0)
    assert np.all(np.any(g[touched] != 0.0, axis=1))


def test_lookup_table_sparse_refuses_an_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        pnn.LookupTableSparse(4, 2, combiner="max", **gen())


# ---- dedup_gather ----------------------------------------------------------

DEDUP_CASES = [
    ("dup_heavy", (32, 4), (48,), 8),
    ("wide_dim1", (40, 1), (64,), 6),
    ("ids_2d", (50, 3), (6, 7), 9),
    ("all_one_id", (5, 2), (33,), 1),
    ("unique", (64, 5), (20,), 64),
]


@pytest.mark.parametrize("name,wshape,ishape,span", DEDUP_CASES,
                         ids=[c[0] for c in DEDUP_CASES])
def test_dedup_gather_backward_equals_the_reference_bit_for_bit(
        name, wshape, ishape, span):
    """test_embedding.py:119, held bit for bit: the forward, the combined
    updates and the table gradient."""
    rng = np.random.default_rng(len(name))
    w = rng.normal(size=wshape).astype(np.float32)
    idx = rng.permutation(span)[:1] if span == 1 else None
    idx = (np.full(ishape, idx[0]) if idx is not None
           else rng.integers(0, span, size=ishape)).astype(np.int32)
    cot = rng.normal(size=ishape + wshape[1:]).astype(np.float32)
    flat = cot.reshape((-1,) + wshape[1:])

    @jax.jit
    def reference(w, cot, flat):
        out, vjp = jax.vjp(lambda a: jdedup_gather(a, jnp.asarray(idx)), w)
        naive = jax.vjp(lambda a: a[jnp.asarray(idx)], w)[1](cot)[0]
        return (out, vjp(cot)[0], naive,
                *jdedup_updates(jnp.asarray(idx).reshape(-1), flat))

    out, want, naive, jrows, jcontrib = (np.asarray(a) for a in reference(
        jnp.asarray(w), jnp.asarray(cot), jnp.asarray(flat)))
    tw = torch.tensor(w, requires_grad=True)
    got = psparse.dedup_gather(tw, torch.tensor(idx))
    np.testing.assert_array_equal(got.detach().numpy(), out)
    got.backward(torch.tensor(cot))
    np.testing.assert_array_equal(tw.grad.numpy(), want)
    # the naive (one row per occurrence) gradient's values
    np.testing.assert_allclose(tw.grad.numpy(), naive, rtol=1e-6,
                               atol=1e-6)
    rows, contrib = psparse.dedup_scatter_updates(torch.tensor(idx),
                                                  torch.tensor(flat))
    np.testing.assert_array_equal(rows.numpy(), jrows)
    np.testing.assert_array_equal(contrib.numpy(), jcontrib)
    nonzero = int(np.sum(np.any(contrib.numpy() != 0.0, axis=1)))
    assert nonzero == np.unique(idx).size


def _runs(lengths, dim, seed):
    rng = np.random.default_rng(seed)
    first = np.zeros(sum(lengths), bool)
    first[np.cumsum([0] + list(lengths[:-1]))] = True
    vals = (rng.normal(size=(sum(lengths), dim))
            * 10.0 ** rng.integers(-3, 4, size=(sum(lengths), 1)))
    return vals.astype(np.float32), first


def test_segment_scan_equals_the_sequential_sum_up_to_three_rows():
    """The card's order (a reverse segmented scan) on the CPU: bit for bit
    the left-to-right sum for runs of 1-3 rows, at every run's first
    row."""
    rng = np.random.default_rng(0)
    lengths = list(rng.integers(1, 4, size=300))
    vals, first = _runs(lengths, 4, 1)
    v, f = torch.tensor(vals), torch.tensor(first)
    seq = psparse.segment_totals(v, f)          # the CPU's index_add_
    scan = psparse.segment_scan(v, f)
    np.testing.assert_array_equal(scan.numpy()[first], seq.numpy()[first])


def test_segment_scan_long_runs_within_a_float64_sum():
    lengths = [1, 2, 5, 17, 64, 3, 130, 1]
    vals, first = _runs(lengths, 3, 2)
    scan = psparse.segment_scan(torch.tensor(vals),
                                torch.tensor(first)).numpy()[first]
    starts = np.flatnonzero(first)
    exact = np.stack([vals[s:s + n].astype(np.float64).sum(0)
                      for s, n in zip(starts, lengths)])
    scale = np.abs(vals).astype(np.float64).max()
    assert np.max(np.abs(scan - exact)) <= 1e-6 * scale * max(lengths)


# ---- every export ------------------------------------------------------------

def test_sparse_module_exports_every_reference_name():
    from bigdl_tpu.nn import sparse as jsp
    assert sorted(psparse.__all__) == sorted(jsp.__all__)
    for n in psparse.__all__:
        assert hasattr(pnn, n), n


def test_containers_structural_aliases():
    """nn/containers.py:225-235: BaseModule, DynamicContainer and
    DynamicGraph are the reference's aliases of Module, Container and
    Graph; a DynamicGraph runs as a Graph."""
    from bigdl_tpu.nn import containers as jc
    from bigdl_tpu_torch.nn import containers as pc
    aliases = {"BaseModule", "DynamicContainer", "DynamicGraph"}
    assert aliases <= set(pc.__all__) & set(jc.__all__)
    assert pnn.BaseModule is pnn.Module
    assert pnn.DynamicContainer is pnn.Container
    assert pnn.DynamicGraph is pnn.Graph
    x = pnn.Input()
    g = pnn.DynamicGraph(x, pnn.ReLU()(x))
    np.testing.assert_array_equal(
        g(torch.tensor([-1.0, 2.0])).numpy(), [0.0, 2.0])
