"""The port's ``ops/control.py`` against the JAX package's, on the CPU.

Restates ``tests/test_control_flow.py`` :26-76 (``Cond``'s branches,
gradients through a parameterized branch, ``WhileLoop`` with its
iteration guard, ``Scan`` carrying state, ``TensorArrayScan``) against
the reference on the same inputs, parameters carried across; its
TF-import cases are ROADMAP.md queue 1, item 13.  A tensor predicate is
read on the host, which a CUDA graph capture cannot record: under a
capture ``Cond`` and ``WhileLoop`` refuse it (the capture is stood in
for here; ``tests/test_torch_cuda.py`` captures one on the card), and a
Python bool goes through.

Tolerance: float32 rtol 1e-5, atol 1e-6 (``test_torch_rnn.OUT``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import ops as jops
from bigdl_tpu.core.module import Module as JModule
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import ops as pops
from bigdl_tpu_torch.ops import control as pcontrol

from test_torch_rnn import OUT, carry, gen, one_torch_thread, rnd  # noqa: F401


class JLam(JModule):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class PLam(pnn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def test_cond_branches_match_reference():
    """test_control_flow.py:26, with the predicate a bool, an array and a
    one-element tensor."""
    x = rnd(2, 3, seed=1)
    jc = jops.Cond(JLam(lambda v: v * 2.0), JLam(lambda v: -v))
    pc = pops.Cond(PLam(lambda v: v * 2.0), PLam(lambda v: -v))
    for pred in (True, False, np.asarray([True]), torch.tensor(False)):
        jp = np.asarray(pred) if torch.is_tensor(pred) else pred
        np.testing.assert_array_equal(
            pc((pred, torch.tensor(x))).numpy(),
            np.asarray(jc((jp, jnp.asarray(x)))))


@pytest.mark.parametrize("pred", [True, False])
def test_cond_gradients_through_the_branch_match_reference(pred):
    """test_control_flow.py:38: the parameterized branch's gradients (and
    none from the branch not taken)."""
    set_seed(1)
    ref = jops.Cond(jnn.Linear(4, 4), jnn.Identity())
    port = carry(ref, pops.Cond(pnn.Linear(4, 4, **gen(1)), pnn.Identity()))
    x = rnd(2, 4, seed=2)
    params, rest = partition(ref)

    def loss(p):
        return jnp.sum(combine(p, rest)((jnp.asarray(pred),
                                         jnp.asarray(x))) ** 2)
    g = jax.grad(loss)(params)
    tx = torch.tensor(x, requires_grad=True)
    (port((pred, tx)) ** 2).sum().backward()
    want = {"true_branch.weight": g.true_branch.weight,
            "true_branch.bias": g.true_branch.bias}
    for name, p in port.named_parameters():
        if pred:
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(want[name]), **OUT)
            assert float(p.grad.abs().max()) > 0
        else:
            assert p.grad is None
            np.testing.assert_array_equal(np.asarray(want[name]), 0.0)


def test_while_loop_and_guard_match_reference():
    """test_control_flow.py:53."""
    jbody, pbody = JLam(lambda s: s + 1.0), PLam(lambda s: s + 1.0)
    for limit in (None, 3, 0):
        jw = jops.WhileLoop(lambda s: s < 10.0, jbody, max_iterations=limit)
        pw = pops.WhileLoop(lambda s: s < 10.0, pbody, max_iterations=limit)
        assert float(pw(torch.tensor(0.0))) == float(jw(jnp.asarray(0.0)))
    # a tuple state and a differentiable body
    jw = jops.WhileLoop(lambda s: s[0] < 4, JLam(lambda s: (s[0] + 1,
                                                            s[1] * 1.5)))
    pw = pops.WhileLoop(lambda s: s[0] < 4, PLam(lambda s: (s[0] + 1,
                                                            s[1] * 1.5)))
    x = rnd(3, seed=3)
    jn, jv = jw((jnp.asarray(0), jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    pn, pv = pw((torch.tensor(0), tx))
    assert int(pn) == int(jn) == 4
    np.testing.assert_allclose(pv.detach().numpy(), np.asarray(jv), **OUT)
    pv.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.full(3, 1.5 ** 4), **OUT)


def test_scan_carries_state_as_the_reference():
    """test_control_flow.py:61, on random steps, time axes 1 and 0, and
    the gradient of a parameterized body."""
    class JAcc(JModule):
        def forward(self, inputs):
            state, x = inputs
            s2 = state * 0.5 + x
            return s2, s2 * 2.0

    class PAcc(pnn.Module):
        def forward(self, inputs):
            state, x = inputs
            s2 = state * 0.5 + x
            return s2, s2 * 2.0

    xs = rnd(2, 5, 3, seed=4)
    s0 = rnd(2, 3, seed=5)
    jf, jys = jops.Scan(JAcc(), time_axis=1)((jnp.asarray(s0),
                                              jnp.asarray(xs)))
    pf, pys = pops.Scan(PAcc(), time_axis=1)((torch.tensor(s0),
                                              torch.tensor(xs)))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), **OUT)
    np.testing.assert_allclose(pys.numpy(), np.asarray(jys), **OUT)
    xs0 = np.moveaxis(xs, 1, 0)
    jf, jys = jops.Scan(JAcc(), time_axis=0)((jnp.asarray(s0),
                                              jnp.asarray(xs0)))
    pf, pys = pops.Scan(PAcc(), time_axis=0)((torch.tensor(s0),
                                              torch.tensor(xs0)))
    np.testing.assert_allclose(pys.numpy(), np.asarray(jys), **OUT)

    # the reference's step through a Linear, the gradients of both
    set_seed(6)

    class JCell(JModule):
        def __init__(self):
            super().__init__()
            self.lin = jnn.Linear(3, 3)

        def forward(self, inputs):
            state, x = inputs
            s2 = jnp.tanh(self.lin(state) + x)
            return s2, s2

    class PCell(pnn.Module):
        def __init__(self):
            super().__init__()
            self.lin = pnn.Linear(3, 3, **gen(6))

        def forward(self, inputs):
            state, x = inputs
            s2 = torch.tanh(self.lin(state) + x)
            return s2, s2

    ref = jops.Scan(JCell())
    port = carry(ref, pops.Scan(PCell()))
    params, rest = partition(ref)

    def loss(p):
        f, ys = combine(p, rest)((jnp.asarray(s0), jnp.asarray(xs)))
        return jnp.sum(ys ** 2) + jnp.sum(f)
    g = jax.grad(loss)(params)
    f, ys = port((torch.tensor(s0), torch.tensor(xs)))
    ((ys ** 2).sum() + f.sum()).backward()
    np.testing.assert_allclose(port.body.lin.weight.grad.numpy(),
                               np.asarray(g.body.lin.weight), **OUT)
    np.testing.assert_allclose(port.body.lin.bias.grad.numpy(),
                               np.asarray(g.body.lin.bias), **OUT)


def test_tensor_array_scan_matches_reference():
    """test_control_flow.py:76, and a body that changes the step's
    shape."""
    xs = rnd(2, 3, 4, seed=7)
    for jb, pb, axes in (
            (JLam(lambda v: v * 2.0), PLam(lambda v: v * 2.0), (1, 2)),
            (JLam(lambda v: v.sum(-1)), PLam(lambda v: v.sum(-1)), (1,))):
        for axis in axes:
            np.testing.assert_allclose(
                pops.TensorArrayScan(pb, time_axis=axis)(
                    torch.tensor(xs)).numpy(),
                np.asarray(jops.TensorArrayScan(jb, time_axis=axis)(
                    jnp.asarray(xs))), **OUT)


def test_host_predicates_are_refused_under_a_capture(monkeypatch):
    """Under a CUDA graph capture (stood in for: the capture check
    answers yes) a tensor predicate raises, naming the way out, where a
    replay would otherwise take the captured branch; a Python bool is
    static and goes through."""
    monkeypatch.setattr(pcontrol, "capturing", lambda: True)
    c = pops.Cond(PLam(lambda v: v + 1), PLam(lambda v: v - 1))
    x = torch.zeros(2)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        c((torch.tensor(True), x))
    w = pops.WhileLoop(lambda s: s < 3, PLam(lambda s: s + 1))
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        w(torch.tensor(0))
    assert torch.equal(c((True, x)), x + 1)
    assert pops.WhileLoop(lambda s: False, PLam(lambda s: s + 1))(x) is x
    s = pops.Scan(PLam(lambda sx: (sx[0] + sx[1], sx[0])))
    assert s((torch.zeros(2), torch.ones(2, 3)))[0].tolist() == [3.0, 3.0]


def test_control_exports_every_reference_name():
    from bigdl_tpu.ops import control as jcontrol
    assert sorted(pcontrol.__all__) == sorted(jcontrol.__all__)
