"""The rest of the port's Module core (``bigdl_tpu_torch.core.module``,
``utils/rng.py``, ``utils/table.py``) against the JAX package's, on the
CPU: ``tests/test_core_module.py`` restated, then ``backward`` against
the reference's vjp, ``clone`` of a sequence-parallel LM,
``get_parameters`` element for element, ``partition`` / ``combine`` /
``tree_map_params`` with a frozen submodule, and one f32 Optimizer step
with a frozen submodule in both packages, eagerly and in a window.

Weights are carried across with ``load_jax_parameters``, never seeds
(Threefry and Philox differ).  Tolerances: forwards and gradients rtol
1e-5, atol 1e-6 (float32, the sums in another order); after an
Optimizer step every parameter rtol 1e-4, atol 1e-5 (the reference's
step sums over 8 CPU devices); copies and flat views bit for bit.
"""

import copy
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import Module as JModule
from bigdl_tpu import Parameter as JParameter
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.core import module as jmodule
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset.image import GreyImgNormalizer as JGrey
from bigdl_tpu.dataset.image import synthetic_mnist as j_synthetic_mnist
from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.utils import next_key, set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core import init as pinit
from bigdl_tpu_torch.core.module import (
    Module, cast_floating, clone, combine, forward_context, freeze,
    is_frozen, next_generator, param_paths, partition, tree_map_params,
    unfreeze,
)
from bigdl_tpu_torch.dataset import (DataSet, GreyImgNormalizer,
                                     SampleToMiniBatch, synthetic_mnist)
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_buffers, load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.parallel import make_mesh
from bigdl_tpu_torch.utils import rng as prng
from bigdl_tpu_torch.utils.table import T, Table

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


# ---- the reference's test models, in both packages -------------------------

class JAffine(JModule):
    def __init__(self, fin, fout):
        super().__init__()
        self.weight = JParameter(jax.random.normal(next_key(), (fout, fin)))
        self.bias = JParameter(jnp.zeros(fout))
        self.calls = jnp.zeros(())

    def forward(self, x):
        self.calls = self.calls + 1
        return x @ self.weight.T + self.bias


class JMLP(JModule):
    def __init__(self):
        super().__init__()
        self.a = JAffine(4, 8)
        self.b = JAffine(8, 2)

    def forward(self, x):
        return self.b(jax.nn.relu(self.a(x)))


class Affine(Module):
    def __init__(self, fin, fout):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(fout, fin))
        self.bias = torch.nn.Parameter(torch.zeros(fout))
        self.register_buffer("calls", torch.zeros(()))

    def forward(self, x):
        self.calls = self.calls + 1
        return x @ self.weight.T + self.bias


class MLP(Module):
    def __init__(self):
        super().__init__()
        self.a = Affine(4, 8)
        self.b = Affine(8, 2)

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def mlp_pair(seed=0):
    set_seed(seed)
    ref = JMLP()
    return ref, load_jax_parameters(MLP(), _np(ref.parameters()))


def x_of(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- tests/test_core_module.py restated -----------------------------------

def test_clone_roundtrip():
    """(``test_pytree_roundtrip``) a clone and a deep copy compute what
    the module computes, from tensors of their own."""
    _, m = mlp_pair()
    x = torch.tensor(x_of(3, 4))
    for other in (m.clone(), copy.deepcopy(m), clone(m)):
        assert torch.equal(other(x), m(x))
        assert other.a.weight.data_ptr() != m.a.weight.data_ptr()


def test_partition_grad_and_buffer_update():
    ref, m = mlp_pair()
    x = x_of(3, 4)
    params, rest = partition(m)
    tensors = {**params, **rest}
    out = torch.func.functional_call(m, tensors, (torch.tensor(x),))
    grads = torch.autograd.grad((out ** 2).sum(), list(params.values()))
    assert len(grads) == 4
    # the forward's buffer write lands in the functional copy only
    assert float(tensors["a.calls"]) == 1.0 and float(m.a.calls) == 0.0

    jp, jr = jmodule.partition(ref)

    def loss_fn(p):
        return jnp.sum(jmodule.combine(p, jr).forward(jnp.asarray(x)) ** 2)
    want = flatten_jax_parameters(_np(jax.grad(loss_fn)(jp).parameters()))
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **TOL,
                                   err_msg=name)


def test_clone_is_functional():
    """(``test_jit_model_as_arg_is_functional``) buffer writes land in the
    copy that ran, never in the module it was cloned from."""
    _, m = mlp_pair()
    x = torch.ones(3, 4)
    m1 = clone(m)
    m1(x)
    m2 = clone(m1)
    m2(x)
    assert float(m.a.calls) == 0.0
    assert float(m1.a.calls) == 1.0 and float(m2.a.calls) == 2.0
    m3 = combine(*partition(m))
    m3(x)
    assert float(m3.a.calls) == 1.0 and float(m.a.calls) == 0.0


def test_freeze_excludes_params():
    ref, m = mlp_pair()
    m.a.freeze()
    ref.a.freeze()
    params, rest = partition(m)
    assert len(params) == 2 and set(rest) >= {"a.weight", "a.bias"}
    assert param_paths(m) == jmodule.param_paths(ref) == \
        ["b.weight", "b.bias"]
    assert m.a.is_frozen() and not m.is_frozen() and is_frozen(m.a)
    m.unfreeze()
    assert len(partition(m)[0]) == 4 and not is_frozen(m.a)
    # by name or dotted path (the reference's layers[i] reads layers.i)
    seq = pnn.Sequential(pnn.Linear(2, 2, generator=torch.Generator(),
                                    device="cpu").set_name("fc"),
                         pnn.ReLU(),
                         pnn.Linear(2, 2, generator=torch.Generator(),
                                    device="cpu"))
    assert param_paths(freeze(seq, "fc")) == ["layers.2.weight",
                                              "layers.2.bias"]
    assert param_paths(freeze(unfreeze(seq), "layers[2]")) == [
        "layers.0.weight", "layers.0.bias"]


def test_get_parameters_flat_view():
    ref, m = mlp_pair()
    flat, unravel = m.get_parameters()
    assert flat.shape == (4 * 8 + 8 + 8 * 2 + 2,)
    tree = unravel(flat)
    assert "a" in tree and "weight" in tree["a"]
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ref.get_parameters()[0]))


def test_train_eval_mode_recursive():
    _, m = mlp_pair()
    m.eval_mode()
    assert not m.a.training and not m.b.training and not m.is_training()
    m.train_mode()
    assert m.a.training and m.is_training()


def test_init_methods_reproducible_under_set_seed():
    """(``test_init_methods_reproducible``) the process-wide generator:
    one seed gives the same generators in order, and each next one
    another stream."""
    prng.set_seed(7)
    g1, g2 = prng.next_generator(), prng.next_generator()
    prng.set_seed(7)
    h1 = prng.next_generator()
    assert prng.get_seed() == 7
    a = pinit.RandomUniform()((16, 16), generator=g1, fan_in=16, fan_out=16)
    b = pinit.RandomUniform()((16, 16), generator=h1, fan_in=16,
                              fan_out=16)
    assert torch.equal(a, b)
    assert not torch.equal(
        a, pinit.RandomUniform()((16, 16), generator=g2, fan_in=16,
                                 fan_out=16))
    # non-average MSRA uses fan_out (InitializationMethod.scala:322)
    msra = pinit.MsraFiller(False)((64, 32, 3, 3),
                                   generator=prng.next_generator())
    assert abs(float(msra.std()) - (2.0 / (64 * 9)) ** 0.5) < 0.01


def test_rng_is_shared_across_threads():
    """A thread's generators continue the count the main thread's seed
    started (the generator is process-wide, not per thread)."""
    prng.set_seed(11)
    seq = [torch.rand(4, generator=prng.next_generator()) for _ in range(3)]
    prng.set_seed(11)
    got = [torch.rand(4, generator=prng.next_generator())]
    t = threading.Thread(target=lambda: got.append(
        torch.rand(4, generator=prng.next_generator())))
    t.start()
    t.join()
    got.append(torch.rand(4, generator=prng.next_generator()))
    for a, b in zip(seq, got):
        assert torch.equal(a, b)


def test_forward_context_generator():
    from bigdl_tpu_torch.core.module import has_generator
    assert not has_generator()
    g = torch.Generator().manual_seed(0)
    with forward_context(generator=g):
        assert has_generator() and next_generator() is g
        a = torch.rand(3, generator=next_generator())
        b = torch.rand(3, generator=next_generator())
        assert not torch.equal(a, b)
    assert not has_generator()
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        next_generator()


def test_buffer_reassignment_keeps_the_buffer_order():
    """(``test_buffer_reassignment_keeps_pytree_structure``) assigning
    buffers in another order keeps their order (the checkpoint tree's)."""
    class M(Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("a", torch.zeros(()))
            self.register_buffer("b", torch.zeros(()))

        def forward(self, x, path=0):
            if path:
                self.b = x.sum()
                self.a = x.sum() * 2
            else:
                self.a = x.sum()
            return x

    m = M()
    m(torch.ones(3), path=0)
    assert [n for n, _ in m.named_buffers()] == ["a", "b"]
    m(torch.ones(3), path=1)
    assert [n for n, _ in m.named_buffers()] == ["a", "b"]
    assert list(m.buffer_tree()) == ["a", "b"]


def test_table_basics():
    """(``tests/test_t7_table_metrics.py::test_table_basics``)"""
    t = T(10, 20, name="x")
    assert t[1] == 10 and t[2] == 20 and t["name"] == "x"
    assert t.length() == 2 and len(t) == 2
    t.insert(30)
    assert t[3] == 30
    assert list(t) == [10, 20, 30]
    assert t.remove() == 30
    assert t.length() == 2
    assert T(1, 2) == T(1, 2) and isinstance(T(), Table)
    assert t.to_tuple() == (10, 20) and "name" in t and t.get("y", 5) == 5


# ---- beyond the reference's own tests --------------------------------------

def test_backward_matches_the_reference_vjp():
    """grad_input against the reference's vjp, in train mode through a
    BatchNorm; the live module's grads and buffers are untouched."""
    set_seed(2)
    ref = jnn.Sequential(jnn.Linear(4, 8), jnn.BatchNormalization(8),
                         jnn.Tanh(), jnn.Linear(8, 3))
    gen = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    port = pnn.Sequential(pnn.Linear(4, 8, **gen),
                          pnn.BatchNormalization(8, **gen),
                          pnn.Tanh(), pnn.Linear(8, 3, **gen))
    load_jax_parameters(port, _np(ref.parameters()))
    load_jax_buffers(port, _np(ref.buffers()))
    x, g = x_of(5, 4, seed=3), x_of(5, 3, seed=4)
    before = {n: b.clone() for n, b in port.named_buffers()}
    got = port.backward(torch.tensor(x), torch.tensor(g))
    want = ref.backward(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(p.grad is None for p in port.parameters())
    for n, b in port.named_buffers():
        assert torch.equal(b, before[n]), n
    # a tuple input gives a tuple of grads

    class Cat(Module):
        def forward(self, xs):
            return torch.cat(xs, -1)

    gx = Cat().backward((torch.ones(2, 3), torch.ones(2, 4)),
                        torch.arange(14.).reshape(2, 7))
    assert torch.equal(gx[1], torch.arange(14.).reshape(2, 7)[:, 3:])


def test_clone_of_the_sequence_parallel_lm():
    """A clone of an LM armed with set_sequence_parallel shares the mesh
    (a static setting), copies every tensor and computes what the armed
    LM does, which is the reference's dense forward."""
    cfg = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4,
               filter_size=64, max_len=64)
    set_seed(0)
    ref = jax_transformer_lm(**cfg).eval_mode()
    port = load_jax_parameters(
        transformer_lm(**cfg, generator=torch.Generator().manual_seed(1),
                       device="cpu").eval(), _np(ref.parameters()))
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    port.set_sequence_parallel(mesh)
    twin = clone(port)
    assert twin.blocks[0].self_attn.mesh is mesh
    assert twin.blocks[1].self_attn.q_layer is not \
        port.blocks[1].self_attn.q_layer
    assert twin.embedding.weight.data_ptr() != \
        port.embedding.weight.data_ptr()
    toks = np.random.default_rng(5).integers(1, 51, (2, 32))
    with torch.no_grad():
        got = twin(toks)
        assert torch.equal(got, port(toks))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref(jnp.asarray(toks))),
                               rtol=2e-4, atol=2e-5)


def test_get_parameters_in_the_reference_order():
    """The flat view orders the nested dict's keys sorted at every level
    (``layers[10]`` before ``layers[2]``), a frozen layer included, as
    ``ravel_pytree(parameters())`` does; unravel goes back."""
    set_seed(6)
    ref = jnn.Sequential(*[jnn.Linear(3, 3) for _ in range(12)])
    port = pnn.Sequential(*[pnn.Linear(3, 3, generator=torch.Generator(),
                                       device="cpu") for _ in range(12)])
    load_jax_parameters(port, _np(ref.parameters()))
    ref.freeze("layers[4]")
    port.freeze("layers[4]")
    flat, unravel = port.get_parameters()
    jflat, _ = ref.get_parameters()
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = flatten_jax_parameters(unravel(flat * 2))
    for name, p in port.named_parameters():
        np.testing.assert_array_equal(back[name], p.detach().numpy() * 2)
    assert port.n_parameters() == ref.n_parameters() == 12 * 12


def test_partition_combine_tree_map_with_a_frozen_submodule():
    ref, port = mlp_pair(3)
    ref.a.freeze()
    freeze(port, "a")
    params, rest = partition(port)
    assert list(params) == param_paths(port) == ["b.weight", "b.bias"]
    assert set(rest) == {"a.weight", "a.bias", "a.calls", "b.calls"}
    doubled = tree_map_params(lambda p: p * 2, port)
    want = flatten_jax_parameters(_np(
        jmodule.tree_map_params(lambda p: p * 2, ref).parameters()))
    for name, p in doubled.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    # the frozen half stays frozen, the source module unchanged
    assert not doubled.a.weight.requires_grad and \
        doubled.b.weight.requires_grad
    x = torch.tensor(x_of(3, 4))
    with torch.no_grad():
        assert torch.equal(combine(params, rest)(x), port(x))
        half = cast_floating(port, torch.float64)
        assert half.b.weight.dtype == torch.float64 and \
            port.b.weight.dtype == torch.float32
        assert cast_floating({"x": x}, torch.bfloat16)["x"].dtype == \
            torch.bfloat16
    with pytest.raises(TypeError, match="needs the module"):
        combine(dict(params), dict(rest))


def _mnist(pkg):
    if pkg == "ref":
        return JDataSet.array(j_synthetic_mnist(64, seed=4), shuffle=False) \
            .transform(JGrey(128.0, 128.0)).transform(JSampleToMiniBatch(32))
    return DataSet.array(synthetic_mnist(64, seed=4), shuffle=False) \
        .transform(GreyImgNormalizer(128.0, 128.0)) \
        .transform(SampleToMiniBatch(32))


def _classifier(m, **kw):
    return m.Sequential(m.Flatten(), m.Linear(784, 16, **kw).set_name("fc1"),
                        m.Tanh(), m.Linear(16, 10, **kw).set_name("fc2"),
                        m.LogSoftMax())


@pytest.mark.parametrize("k", [1, 2], ids=["eager", "window"])
def test_optimizer_step_with_a_frozen_submodule_in_both_packages(k):
    """fc1 frozen in both: one epoch (2 steps of SGD with momentum) leaves
    it bit for bit where it was, gives it no optim state, and trains fc2
    to the reference's weights."""
    set_seed(8)
    ref = _classifier(jnn)
    port = load_jax_parameters(
        _classifier(pnn, generator=torch.Generator(), device="cpu"),
        _np(ref.parameters()))
    ref.freeze("fc1")
    port.freeze("fc1")
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    ref_opt = joptim.Optimizer(ref, _mnist("ref"), jnn.ClassNLLCriterion()) \
        .set_optim_method(joptim.SGD(0.1, momentum=0.9, dampening=0.0)) \
        .set_end_when(joptim.Trigger.max_epoch(1)) \
        .set_iterations_per_dispatch(k)
    port_opt = Optimizer(port, _mnist("port"), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0)) \
        .set_end_when(Trigger.max_epoch(1)) \
        .set_iterations_per_dispatch(k)
    ref_opt.optimize()
    port_opt.optimize()
    want = flatten_jax_parameters(_np(ref.parameters()))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   **STEP_TOL, err_msg=name)
    for name in ("layers.1.weight", "layers.1.bias"):
        assert torch.equal(port.get_parameter(name), start[name])
    assert not torch.equal(port.layers[3].weight, start["layers.3.weight"])
    assert len(port_opt._opt_states[0]["velocity"]) == 2
    assert port_opt.state["neval"] == ref_opt.state["neval"] == 3
    assert port_opt.dispatch_stats["window_steps"] == (2 if k == 2 else 0)


def test_parameter_and_buffer_trees():
    set_seed(9)
    ref = jnn.Sequential(jnn.Linear(3, 4), jnn.BatchNormalization(4))
    port = pnn.Sequential(pnn.Linear(3, 4, generator=torch.Generator(),
                                     device="cpu"),
                          pnn.BatchNormalization(
                              4, generator=torch.Generator(), device="cpu"))
    port.load_parameters(_np(ref.parameters()))
    port.load_buffers({"layers[1]": {"running_mean": np.full(4, 0.5)}})
    tree = port.parameter_tree()
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda t: 0, tree)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, ref.parameters()))
    for name, value in flatten_jax_parameters(_np(ref.parameters())) \
            .items():
        np.testing.assert_array_equal(
            port.get_parameter(name).detach().numpy(), value)
    buffers = flatten_jax_parameters(
        jax.tree_util.tree_map(lambda t: t.numpy(), port.buffer_tree()))
    np.testing.assert_array_equal(buffers["layers.1.running_mean"],
                                  np.full(4, 0.5, np.float32))
    np.testing.assert_array_equal(buffers["layers.1.running_var"],
                                  np.ones(4, np.float32))


def test_unported_persistence_raises_naming_its_item(tmp_path):
    _, m = mlp_pair()
    for call in (lambda: m.save(str(tmp_path / "m")),
                 lambda: Module.load(str(tmp_path / "m")),
                 lambda: m.save_weights(str(tmp_path / "w")),
                 lambda: m.load_weights(str(tmp_path / "w"))):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()
    # quantize is ported (tests/test_torch_quantized.py): an eval-mode
    # copy, here with nothing to swap (no Linear of exact type), the
    # module left as it was
    q = m.quantize()
    assert q is not m and not q.training and m.training
    x = torch.tensor(x_of(3, 4))
    assert torch.equal(q(x), m(x))
