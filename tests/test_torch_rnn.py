"""The port's ``nn/rnn.py`` against the JAX package's, on the CPU: every
class, from the same numpy inputs and cotangents, parameters carried
across by ``load_jax_parameters``; the forward, and the gradients of the
input and of every parameter (the reference's through eager
``jax.vjp``).

Restates ``tests/test_oracle_sweep_extended.py`` :243-336 (the cell
sweep through ``Recurrent``; ``MultiRNNCell`` against the composition),
:390 (``TimeDistributed``) and :716-733 (``RecurrentDecoder`` feeds its
output back), and ``tests/test_layers_torch_oracle.py`` :304-325
(``BiRecurrent``'s positional cell and its refusal, the strided
``ConvLSTMPeephole`` through ``Recurrent``, and LSTM input dropout).

Tolerance: float32 rtol 1e-5, atol 1e-6 on outputs and on every
gradient (the same formulas, one rounding or summation order apart; a
weight's gradient sums batch x time products, which these sizes keep
within it).  Masks cannot match across the two RNGs, so input dropout is
held by its statistics, its arithmetic against the same mask drawn
from a twin generator, and its determinism under one generator.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core.module import dropout, forward_context
from bigdl_tpu_torch.interop import (flatten_jax_parameters,
                                     load_jax_buffers, load_jax_parameters)

OUT = GRAD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch in one thread (autouse here, and where imported): these
    small tensors gain nothing from more, and beside other test workers
    on the same cores torch's thread pool made a 0.5 s Inception
    training run take 130 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gen(seed=0):
    return dict(generator=torch.Generator().manual_seed(seed), device="cpu")


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def carry(ref, port):
    """The reference module's parameters and buffers into the port's."""
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    buffers = jax.tree_util.tree_map(np.asarray, ref.buffers())
    if buffers:
        load_jax_buffers(port, buffers)
    return port


def _np_tree(tree):
    """{port name: array} of a nested reference dict, a frozen module's
    ``None`` leaves left out."""
    return {k: v for k, v in flatten_jax_parameters(
        jax.tree_util.tree_map(np.asarray, tree)).items()
        if v.dtype != object}


def run_both(ref, port, inputs, train=False, jit=False, grad_inputs=True):
    """One forward and backward of ``ref`` (``jax.vjp`` over its
    parameters and floating inputs, eagerly, or under one ``jax.jit``
    with ``jit``, cheaper for a whole model, whose eager ops compile one
    by one) and of ``port`` (autograd), through the same random
    cotangent; ``train`` sets both modes; without ``grad_inputs`` the
    inputs are constants.  Returns (want, got), each
    {"out", "grads" by port name, "dx": [input grads], "buffers"}."""
    ref = ref.train_mode() if train else ref.eval_mode()
    port.train(train)
    params, rest = partition(ref)
    float_at = [i for i, a in enumerate(inputs) if grad_inputs
                and np.issubdtype(np.asarray(a).dtype, np.floating)]

    def f(p, *diff, r=rest):
        xs = [jnp.asarray(a) for a in inputs]
        for i, d in zip(float_at, diff):
            xs[i] = d
        m = combine(p, r)
        return m(*xs), m.buffers()

    diff = [jnp.asarray(inputs[i]) for i in float_at]
    if jit:
        cot = rnd(*jax.eval_shape(f, params, *diff)[0].shape, seed=50)

        # the frozen parameters go in as an argument: closed over, they
        # would be compiled into the program as constants
        def loss(p, r, *d):
            y, bufs = f(p, *d, r=r)
            return jnp.sum(y * cot), (y, bufs)
        (_, (y, bufs)), (gp, *gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, *range(2, 2 + len(diff))), has_aux=True))(
                params, rest, *diff)
    else:
        y, vjp, bufs = jax.vjp(f, params, *diff, has_aux=True)
        cot = rnd(*np.shape(y), seed=50)
        gp, *gx = vjp(jnp.asarray(cot))
    want = {"out": np.asarray(y), "grads": _np_tree(gp.parameters()),
            "dx": [np.asarray(g) for g in gx], "buffers": _np_tree(bufs)}

    xs = [torch.tensor(np.asarray(a)) for a in inputs]
    for i in float_at:
        xs[i].requires_grad_(True)
    port.zero_grad(set_to_none=True)
    out = port(*xs)
    (out * torch.tensor(cot)).sum().backward()
    got = {"out": out.detach().numpy(),
           "grads": {n: (np.zeros(tuple(p.shape), np.float32)
                         if p.grad is None else p.grad.numpy())
                     for n, p in port.named_parameters()},
           "dx": [xs[i].grad.numpy() for i in float_at],
           "buffers": {n: b.detach().numpy()
                       for n, b in port.named_buffers()}}
    return want, got


def assert_run(want, got, out=OUT, grad=GRAD):
    np.testing.assert_allclose(got["out"], want["out"], **out)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], w, **grad,
                                   err_msg=name)
    for g, w in zip(got["dx"], want["dx"]):
        np.testing.assert_allclose(g, w, **grad, err_msg="input")
    assert set(got["buffers"]) == set(want["buffers"])
    for name, w in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][name], w, **out,
                                   err_msg=name)


# ---- the cell sweep through Recurrent (test_oracle_sweep_extended.py:243) --

CELLS = {
    "RnnCell": lambda m: m.RnnCell(6, 5),
    "RnnCell_relu": lambda m: m.RnnCell(6, 5, m.ReLU()),
    "LSTM": lambda m: m.LSTM(6, 5),
    "LSTM_activations": lambda m: m.LSTM(6, 5, 0.0, m.SoftSign(),
                                          m.HardSigmoid()),
    "LSTMPeephole": lambda m: m.LSTMPeephole(6, 5),
    "GRU": lambda m: m.GRU(6, 5),
    "GRU_activations": lambda m: m.GRU(6, 5, 0.0, m.SoftSign(),
                                       m.HardSigmoid()),
    "RNN": lambda m: m.RNN(6, 5),
}


def _port_cell(make):
    """``make`` on a namespace whose cells take the port's keywords."""
    class _P:
        def __getattr__(self, name):
            cls = getattr(pnn, name)
            if issubclass(cls, pnn.Cell):
                return lambda *a, **k: cls(*a, **k, **gen())
            return cls
    return make(_P())


def _peepholes(ref):
    """Move zero-initialised peephole weights off zero, so that their
    gradients and products are held too."""
    params = jax.tree_util.tree_map(np.asarray, ref.parameters())
    flat = flatten_jax_parameters(params)
    moved = {k: v + rnd(*v.shape, seed=len(k)) * 0.3 if "peep" in k
             or k.endswith("bias") else v for k, v in flat.items()}
    from bigdl_tpu_torch.interop import nest_jax_parameters
    ref.load_parameters(jax.tree_util.tree_map(
        jnp.asarray, nest_jax_parameters(moved)))
    return ref


@pytest.mark.parametrize("name", sorted(CELLS))
def test_recurrent_cell_matches_reference(name):
    set_seed(sum(map(ord, name)))
    ref = _peepholes(jnn.Recurrent(CELLS[name](jnn)))
    port = carry(ref, pnn.Recurrent(_port_cell(CELLS[name])))
    assert_run(*run_both(ref, port, [rnd(3, 4, 6, seed=80)]))


@pytest.mark.parametrize("name", ["LSTM", "GRU", "RnnCell"])
def test_cell_single_step_and_initial_state(name):
    """``cell(x)`` is one step from the zero state; the state's shapes
    are the reference's."""
    set_seed(5)
    ref = _peepholes(CELLS[name](jnn))
    port = carry(ref, _port_cell(CELLS[name]))
    x = rnd(3, 6, seed=81)
    out, state = ref.eval_mode()(jnp.asarray(x))
    pout, pstate = port.eval()(torch.tensor(x))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(out), **OUT)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                               pstate))):
        np.testing.assert_allclose(b, np.asarray(a), **OUT)
    leaves = jax.tree_util.tree_leaves
    assert [tuple(t.shape) for t in leaves(port.init_state(3,
                                                           device="cpu"))] \
        == [np.shape(a) for a in leaves(ref.init_state(3))]


def test_multi_rnn_cell_matches_reference_and_composition():
    """MultiRNNCell([a, b]) against the reference, and against feeding
    a's output stream into b (test_oracle_sweep_extended.py:320)."""
    set_seed(2)
    ref = jnn.Recurrent(jnn.MultiRNNCell([jnn.RnnCell(6, 6),
                                          jnn.RnnCell(6, 5)]))
    port = carry(ref, pnn.Recurrent(pnn.MultiRNNCell(
        [pnn.RnnCell(6, 6, **gen()), pnn.RnnCell(6, 5, **gen(1))])))
    assert_run(*run_both(ref, port, [rnd(3, 4, 6, seed=81)]))
    a, b = port.cell.cells
    x = torch.tensor(rnd(3, 4, 6, seed=82))
    with torch.no_grad():
        np.testing.assert_allclose(
            port(x).numpy(),
            pnn.Recurrent(b)(pnn.Recurrent(a)(x)).numpy(), **OUT)


def test_stacked_lstm_matches_reference_in_train_mode():
    """The PTB path: two LSTMs in a MultiRNNCell, each projecting its own
    timestep, and a GRU over an LSTM."""
    set_seed(3)
    ref = jnn.Recurrent(jnn.MultiRNNCell([jnn.LSTM(6, 8), jnn.LSTM(8, 8),
                                          jnn.GRU(8, 5)]))
    port = carry(ref, pnn.Recurrent(pnn.MultiRNNCell(
        [pnn.LSTM(6, 8, **gen()), pnn.LSTM(8, 8, **gen()),
         pnn.GRU(8, 5, **gen())])))
    assert_run(*run_both(ref, port, [rnd(2, 5, 6, seed=83)], train=True))


@pytest.mark.parametrize("merge", [None, "Pack"])
def test_birecurrent_matches_reference(merge):
    set_seed(4)
    if merge is None:
        ref = jnn.BiRecurrent(jnn.LSTM(4, 6))
        port = pnn.BiRecurrent(pnn.LSTM(4, 6, **gen()))
    else:
        ref = jnn.BiRecurrent(jnn.Pack(3), jnn.GRU(4, 6), jnn.GRU(4, 6))
        port = pnn.BiRecurrent(pnn.Pack(3), pnn.GRU(4, 6, **gen()),
                               pnn.GRU(4, 6, **gen(1)))
    carry(ref, port)
    want, got = run_both(ref, port, [rnd(2, 3, 4, seed=84)])
    assert got["out"].shape == ((2, 3, 12) if merge is None else (2, 3, 2, 6))
    assert_run(want, got)


def test_birecurrent_positional_cell_and_its_refusal():
    """test_layers_torch_oracle.py:304: the reverse pass runs a clone of
    the cell (same weights, its own tensors)."""
    cell = pnn.LSTM(4, 6, **gen())
    bi = pnn.BiRecurrent(cell)
    assert bi(torch.ones(2, 3, 4)).shape == (2, 3, 12)
    assert bi.bwd.cell is not cell
    assert torch.equal(bi.bwd.cell.w_input, cell.w_input)
    assert bi.bwd.cell.w_input.data_ptr() != cell.w_input.data_ptr()
    with pytest.raises(ValueError, match="needs a cell"):
        pnn.BiRecurrent()


@pytest.mark.parametrize("stride,peephole", [(1, True), (2, True),
                                             (1, False)])
def test_conv_lstm_peephole_matches_reference(stride, peephole):
    """Through Recurrent; stride 2 halves the state's grid
    (test_layers_torch_oracle.py:312)."""
    set_seed(6)
    ref = _peepholes(jnn.Recurrent(jnn.ConvLSTMPeephole(
        3, 4, stride=stride, with_peephole=peephole)))
    port = carry(ref, pnn.Recurrent(pnn.ConvLSTMPeephole(
        3, 4, stride=stride, with_peephole=peephole, **gen())))
    want, got = run_both(ref, port, [rnd(2, 3, 6, 6, 3, seed=85)])
    assert got["out"].shape == (2, 3, 6 // stride, 6 // stride, 4)
    assert_run(want, got)


def test_conv_lstm_peephole_3d_matches_reference():
    set_seed(7)
    ref = _peepholes(jnn.Recurrent(jnn.ConvLSTMPeephole3D(2, 3)))
    port = carry(ref, pnn.Recurrent(pnn.ConvLSTMPeephole3D(2, 3, **gen())))
    assert_run(*run_both(ref, port, [rnd(1, 2, 4, 4, 4, 2, seed=86)]))
    with pytest.raises(ValueError, match="spatial"):
        pnn.ConvLSTMPeephole(3, 4, **gen()).init_state(2)


def test_recurrent_decoder_matches_reference_and_feeds_back():
    """test_oracle_sweep_extended.py:716: the input of step t + 1 is the
    output of step t."""
    set_seed(4)
    ref = jnn.RecurrentDecoder(3, jnn.RnnCell(5, 5))
    port = carry(ref, pnn.RecurrentDecoder(3, pnn.RnnCell(5, 5, **gen())))
    want, got = run_both(ref, port, [rnd(2, 5, seed=130)])
    assert_run(want, got)
    cell = port.cell
    h = cell.init_state(2, device="cpu")
    inp, outs = torch.tensor(rnd(2, 5, seed=130)), []
    with torch.no_grad():
        for _ in range(3):
            o, h = cell.step(cell.precompute_inputs(inp), h)
            outs.append(o.numpy())
            inp = o
    np.testing.assert_allclose(got["out"], np.stack(outs, 1), **OUT)


def test_time_distributed_matches_reference():
    """test_oracle_sweep_extended.py:390."""
    set_seed(8)
    ref = jnn.TimeDistributed(jnn.Linear(5, 3))
    port = carry(ref, pnn.TimeDistributed(pnn.Linear(5, 3, **gen())))
    assert_run(*run_both(ref, port, [rnd(3, 4, 5, seed=102)]))


# ---- input dropout -----------------------------------------------------------

def test_lstm_input_dropout_active():
    """test_layers_torch_oracle.py:320: two generators give two outputs,
    one generator the same output twice, eval mode none."""
    rec = pnn.Recurrent(pnn.LSTM(4, 6, p=0.5, **gen()))
    x = torch.ones(2, 3, 4)

    def run(seed):
        with forward_context(generator=torch.Generator().manual_seed(seed)):
            return rec(x)
    assert not torch.allclose(run(0), run(1))
    assert torch.equal(run(0), run(0))
    rec.eval()
    assert torch.equal(rec(x), rec(x))
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        rec.train()(x)


@pytest.mark.parametrize("name", ["LSTM", "LSTMPeephole", "GRU"])
def test_input_dropout_is_the_hoisted_mask(name):
    """A single cell drops its whole input sequence once, before the
    hoisted projection: the same as the cell without dropout on
    ``dropout(x, p)`` drawn from a twin of the generator."""
    cell = getattr(pnn, name)(4, 6, p=0.3, **gen())
    plain = getattr(pnn, name)(4, 6, **gen())
    x = torch.tensor(rnd(2, 5, 4, seed=87))
    with forward_context(generator=torch.Generator().manual_seed(3)):
        got = pnn.Recurrent(cell)(x)
    with forward_context(generator=torch.Generator().manual_seed(3)):
        masked = dropout(x, 0.3)
    np.testing.assert_allclose(got.detach().numpy(), pnn.Recurrent(plain)(
        masked).detach().numpy(), **OUT)


def test_multi_rnn_cell_drops_each_step_of_each_layer():
    """MultiRNNCell hoists nothing: each layer's input dropout is drawn
    at each step on that step alone, in layer order."""
    a, b = pnn.LSTM(4, 6, p=0.5, **gen()), pnn.LSTM(6, 6, p=0.5, **gen(1))
    pa, pb = pnn.LSTM(4, 6, **gen()), pnn.LSTM(6, 6, **gen(1))
    x = torch.tensor(rnd(2, 3, 4, seed=88))
    with forward_context(generator=torch.Generator().manual_seed(9)):
        got = pnn.Recurrent(pnn.MultiRNNCell([a, b]))(x)
    with forward_context(generator=torch.Generator().manual_seed(9)):
        sa, sb = pa.init_state(2, device="cpu"), pb.init_state(2,
                                                               device="cpu")
        outs = []
        for t in range(3):
            o, sa = pa.step(pa.precompute_inputs(dropout(x[:, t:t + 1],
                                                         0.5))[:, 0], sa)
            o, sb = pb.step(pb.precompute_inputs(dropout(o[:, None],
                                                         0.5))[:, 0], sb)
            outs.append(o)
    np.testing.assert_allclose(got.detach().numpy(),
                               torch.stack(outs, 1).detach().numpy(), **OUT)


def test_input_dropout_keep_rate_and_scale():
    """Over 40,000 entries the kept share is 1 - p within 4 standard
    errors, each kept entry x / (1 - p)."""
    p = 0.3
    x = torch.full((100, 100, 4), 2.0)
    with forward_context(generator=torch.Generator().manual_seed(11)):
        y = pnn.LSTM(4, 6, p=p, **gen())._input_dropout(x, p)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) < 4 * (p * (1 - p) / x.numel()) ** 0.5
    assert torch.all(y[kept] == 2.0 / (1 - p))


# ---- inits and exports -------------------------------------------------------

def test_cell_inits_follow_the_reference():
    """w ~ U(-1/sqrt(H), 1/sqrt(H)) with the reference's shapes, biases
    and peepholes zero, equal under one generator."""
    for name in ("RnnCell", "LSTM", "LSTMPeephole", "GRU"):
        ref = getattr(jnn, name)(7, 9)
        port = getattr(pnn, name)(7, 9, **gen(2))
        again = getattr(pnn, name)(7, 9, **gen(2))
        shapes = {k: v.shape for k, v in _np_tree(ref.parameters()).items()}
        assert {n: tuple(p.shape) for n, p in port.named_parameters()} == \
            {k: tuple(s) for k, s in shapes.items()}
        for (n, p), q in zip(port.named_parameters(), again.parameters()):
            p = p.detach()
            assert torch.equal(p, q)
            if n.startswith("w_"):
                assert float(p.abs().max()) <= 1 / 3 and float(p.std()) > 0.1
            else:
                assert not p.any()


def test_rnn_module_exports_every_reference_class():
    from bigdl_tpu.nn import rnn as jr
    from bigdl_tpu_torch.nn import rnn as pr
    assert sorted(pr.__all__) == sorted(jr.__all__)
    assert pnn.RNN is pnn.RnnCell
