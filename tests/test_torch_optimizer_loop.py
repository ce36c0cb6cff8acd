"""The port's ``Optimizer`` façade against the JAX package's, on the CPU,
from the same numpy data and bridged weights: the layers' regularizers
and gradient scales, both gradient clippings, per-submodule optim
methods, ``Optimizer(batch_size=...)`` over ``Sample``s, and the
iterations ``set_validation``'s trigger fires on.  Then
``tests/test_dispatch_window.py``'s cases restated against the port's
``set_iterations_per_dispatch``: on the CPU a window runs its steps
eagerly one at a time, so k windows must train to the weights of k=1 bit
for bit and fire the triggers on the same iterations; SGD's learning
rate in a 0-dim tensor (as a captured graph reads it) must equal the
float path bit for bit.

Tolerances against the reference: every parameter rtol 1e-4, atol 1e-5
after 16 SGD steps of a 784-32-10 MLP (the reference's SPMD sums over 8
CPU devices go in another order; measured below 1e-6).  Between the
port's own runs: bit for bit.
"""

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset.image import GreyImgNormalizer as JGrey
from bigdl_tpu.dataset.image import synthetic_mnist as j_synthetic_mnist
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core.module import forward_context
from bigdl_tpu_torch.dataset import (DataSet, GreyImgNormalizer, MiniBatch,
                                     Sample, SampleToMiniBatch,
                                     synthetic_mnist)
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_parameters
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.methods import Default
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               leaf_reg_specs)
from bigdl_tpu_torch.optim.validation import (Loss, MAE, Top1Accuracy,
                                              Top5Accuracy)

TOL = dict(rtol=1e-4, atol=1e-5)


def _pipeline(pkg, n=256, batch=32, seed=0):
    if pkg == "ref":
        return JDataSet.array(j_synthetic_mnist(n, seed=seed),
                              shuffle=False) \
            .transform(JGrey(128.0, 128.0)) \
            .transform(JSampleToMiniBatch(batch))
    return DataSet.array(synthetic_mnist(n, seed=seed), shuffle=False) \
        .transform(GreyImgNormalizer(128.0, 128.0)) \
        .transform(SampleToMiniBatch(batch))


def _mlp(pkg, wreg=None, breg=None):
    if pkg == "ref":
        m = jnn
        lin = dict(w_regularizer=wreg, b_regularizer=breg)
        lin2 = {}
    else:
        m = pnn
        gen = torch.Generator().manual_seed(0)
        lin = dict(w_regularizer=wreg, b_regularizer=breg, generator=gen,
                   device="cpu")
        lin2 = dict(generator=gen, device="cpu")
    return m.Sequential(
        m.Flatten(), m.Linear(784, 32, **lin).set_name("fc1"), m.Tanh(),
        m.Linear(32, 10, **lin2).set_name("fc2"), m.LogSoftMax())


def _pair(wreg=None, breg=None, jreg=None):
    """The reference MLP and its port from the same weights; ``jreg`` is
    (w, b) for the reference's first Linear."""
    set_seed(23)
    ref = _mlp("ref", *(jreg or (None, None)))
    port = _mlp("port", wreg, breg)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    return ref, port


def _run(ref, port, configure, epochs=2):
    ref_opt = joptim.Optimizer(ref, _pipeline("ref"),
                               jnn.ClassNLLCriterion()) \
        .set_optim_method(joptim.SGD(0.1, momentum=0.9, dampening=0.0)) \
        .set_end_when(joptim.Trigger.max_epoch(epochs))
    port_opt = Optimizer(port, _pipeline("port"), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0)) \
        .set_end_when(Trigger.max_epoch(epochs))
    configure(ref_opt, joptim)
    configure(port_opt, None)
    ref_opt.optimize()
    port_opt.optimize()
    want = flatten_jax_parameters(ref.parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], **TOL,
                                   err_msg=name)
    assert port_opt.state["neval"] == ref_opt.state["neval"]
    np.testing.assert_allclose(port_opt.state["loss"],
                               ref_opt.state["loss"], rtol=1e-4)
    return ref_opt, port_opt


# ---- regularizers, clipping, per-group methods ------------------------

@pytest.mark.parametrize("reg", ["l1", "l2", "l1l2_bias"])
def test_regularizers_match_reference(reg):
    w = {"l1": L1Regularizer(1e-3), "l2": L2Regularizer(1e-2),
         "l1l2_bias": L1L2Regularizer(1e-3, 1e-2)}[reg]
    b = L2Regularizer(5e-2) if reg == "l1l2_bias" else None
    jw = {"l1": joptim.L1Regularizer(1e-3), "l2": joptim.L2Regularizer(1e-2),
          "l1l2_bias": joptim.L1L2Regularizer(1e-3, 1e-2)}[reg]
    jb = joptim.L2Regularizer(5e-2) if reg == "l1l2_bias" else None
    ref, port = _pair(w, b, (jw, jb))
    _, port_opt = _run(ref, port, lambda o, _: o)
    # the regularizer moved the weights: without it they differ
    _, bare = _pair()
    Optimizer(bare, _pipeline("port"), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0)) \
        .set_end_when(Trigger.max_epoch(2)).optimize()
    assert not torch.equal(bare.layers[1].weight, port.layers[1].weight)


def test_set_regularizers_and_gradient_scales_match_reference():
    ref, port = _pair()
    ref.layers[3].set_regularizers(
        w_regularizer=joptim.L2Regularizer(1e-2)).set_scale_w(0.5)
    ref.layers[1].set_scale_b(2.0)
    port.layers[3].set_regularizers(
        w_regularizer=L2Regularizer(1e-2)).set_scale_w(0.5)
    port.layers[1].set_scale_b(2.0)
    assert leaf_reg_specs(port) == [(0.0, 0.0, 1.0), (0.0, 0.0, 2.0),
                                    (0.0, 1e-2, 0.5), (0.0, 0.0, 1.0)]
    _run(ref, port, lambda o, _: o)


@pytest.mark.parametrize("clip", ["l2_norm", "constant", "both"])
def test_gradient_clipping_matches_reference(clip):
    ref, port = _pair(L2Regularizer(1e-2), None,
                      (joptim.L2Regularizer(1e-2), None))

    def configure(opt, _):
        if clip in ("l2_norm", "both"):
            opt.set_gradient_clipping_by_l2_norm(0.05)
        if clip in ("constant", "both"):
            opt.set_constant_gradient_clipping(-1e-3, 2e-3)
    _run(ref, port, configure)


def test_disable_gradient_clipping_restores_the_plain_step():
    _, a = _pair()
    _, b = _pair()
    Optimizer(a, _pipeline("port"), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.1)).set_end_when(Trigger.max_epoch(1)) \
        .optimize()
    Optimizer(b, _pipeline("port"), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.1)).set_end_when(Trigger.max_epoch(1)) \
        .set_gradient_clipping_by_l2_norm(1e-3) \
        .set_constant_gradient_clipping(-1e-4, 1e-4) \
        .disable_gradient_clipping().optimize()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("keys", ["names", "paths"])
def test_per_group_methods_match_reference(keys):
    ref, port = _pair()
    k1, k2 = ("fc1", "fc2") if keys == "names" else ("layers.1", "layers.3")
    jk1, jk2 = ("fc1", "fc2") if keys == "names" else ("layers[1]",
                                                       "layers[3]")

    def configure(opt, pkg):
        if pkg is None:
            opt.set_optim_methods({
                k1: SGD(0.1, momentum=0.9, dampening=0.0),
                k2: SGD(0.02, learning_rate_decay=0.1)})
        else:
            opt.set_optim_methods({
                jk1: pkg.SGD(0.1, momentum=0.9, dampening=0.0),
                jk2: pkg.SGD(0.02, learning_rate_decay=0.1)})
    _run(ref, port, configure)


def test_per_group_methods_keep_their_own_state_and_refuse_gaps():
    _, port = _pair()
    opt = Optimizer(port, _pipeline("port"), pnn.ClassNLLCriterion()) \
        .set_optim_methods({"fc1": SGD(0.1, momentum=0.9),
                            "fc2": SGD(0.01)}) \
        .set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    assert [len(idx) for idx in opt._group_idx] == [2, 2]
    assert [s["t"] for s in opt._opt_states] == [3, 3]
    assert "velocity" in opt._opt_states[0] \
        and "velocity" not in opt._opt_states[1]
    with pytest.raises(ValueError, match="no optim method covers"):
        Optimizer(port, _pipeline("port"), pnn.ClassNLLCriterion()) \
            .set_optim_methods({"fc1": SGD(0.1)}).optimize()


# ---- batch_size= and Sample, validation --------------------------------

def test_batch_size_over_samples_matches_reference():
    """A list of raw Samples batched by the Optimizer, shuffled by its
    seed as the reference's by its process seed."""
    ref, port = _pair()
    set_seed(7)
    jsamples = [s for s in j_synthetic_mnist(200, seed=1)]
    ref_opt = joptim.Optimizer(ref, [type(s)(s.feature / 128.0, s.label)
                                     for s in jsamples],
                               jnn.ClassNLLCriterion(), batch_size=40) \
        .set_optim_method(joptim.SGD(0.1)) \
        .set_end_when(joptim.Trigger.max_epoch(2))
    samples = [Sample(s.feature / 128.0, s.label)
               for s in synthetic_mnist(200, seed=1)]
    port_opt = Optimizer(port, samples, pnn.ClassNLLCriterion(),
                         batch_size=40, seed=7) \
        .set_optim_method(SGD(0.1)).set_end_when(Trigger.max_epoch(2))
    ref_opt.optimize()
    port_opt.optimize()
    assert port_opt.state["neval"] == ref_opt.state["neval"] == 11
    assert port_opt.state["records"] == ref_opt.state["records"] == 200
    want = flatten_jax_parameters(ref.parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], **TOL)


def test_sample_to_minibatch_pads_and_keeps_a_ragged_tail():
    samples = [Sample(np.ones((n,), np.float32), np.arange(n))
               for n in (2, 3, 1)]
    out = list(SampleToMiniBatch(2, padding_value=-1, drop_last=False)(
        iter(samples)))
    assert [b.size() for b in out] == [2, 1]
    np.testing.assert_array_equal(out[0].get_input(),
                                  [[1, 1, -1], [1, 1, 1]])
    np.testing.assert_array_equal(out[0].get_target(),
                                  [[0, 1, -1], [0, 1, 2]])
    same = [Sample(np.full((3,), i, np.float32), i) for i in range(5)]
    assert [b.size() for b in SampleToMiniBatch(2)(iter(same))] == [2, 2]


def _recording(method_cls, log, opt_ref):
    class Recording(method_cls):
        def to_result(self, num, den):
            log.append(opt_ref[0].state["neval"])
            return super().to_result(num, den)
    return Recording()


@pytest.mark.parametrize("trigger,k", [("several_iteration", 1),
                                       ("every_epoch", 1),
                                       ("several_iteration", 4)])
def test_validation_fires_on_the_reference_iterations(trigger, k):
    ref, port = _pair()
    logs = {"ref": [], "port": []}
    holders = {"ref": [None], "port": [None]}

    def configure(opt, pkg):
        side = "port" if pkg is None else "ref"
        holders[side][0] = opt
        trig = (pkg.Trigger if pkg else Trigger)
        t = (trig.several_iteration(3) if trigger == "several_iteration"
             else trig.every_epoch())
        val = _pipeline("ref" if pkg else "port", 64, 32, 7)
        methods = ([_recording(pkg.Top1Accuracy, logs[side], holders[side]),
                    pkg.Top5Accuracy(), pkg.Loss(jnn.ClassNLLCriterion())]
                   if pkg else
                   [_recording(Top1Accuracy, logs[side], holders[side]),
                    Top5Accuracy(), Loss(pnn.ClassNLLCriterion())])
        opt.set_validation(t, val, methods)
        if k > 1:
            opt.set_iterations_per_dispatch(k)
    ref_opt, port_opt = _run(ref, port, configure)
    assert logs["port"] == logs["ref"] and logs["port"]
    np.testing.assert_allclose(port_opt.state["score"],
                               ref_opt.state["score"], atol=1e-6)
    # two validation batches per validation
    assert [n for n, _ in port_opt.validation_history] == logs["port"][::2]
    last = port_opt.validation_history[-1][1]
    assert set(last) == {"Top1Accuracy", "Top5Accuracy", "Loss"}
    assert last["Top5Accuracy"].result()[0] >= last["Top1Accuracy"].result()[0]
    assert last["Loss"].result()[1] == 64


def test_validation_methods_match_reference():
    rng = np.random.default_rng(3)
    out = rng.normal(size=(16, 10)).astype(np.float32)
    y = rng.integers(1, 11, size=(16,))
    for port_m, ref_m in ((Top1Accuracy(), joptim.Top1Accuracy()),
                          (Top5Accuracy(), joptim.Top5Accuracy()),
                          (Loss(), joptim.Loss()), (MAE(), joptim.MAE())):
        target = y if not isinstance(port_m, MAE) else out * 0.5
        got = port_m(torch.tensor(out), torch.tensor(target))
        want = ref_m(jax.numpy.asarray(out), jax.numpy.asarray(target))
        assert got.fmt == want.fmt
        np.testing.assert_allclose(got.result()[0], want.result()[0],
                                   rtol=1e-6)
        assert got.result()[1] == want.result()[1]
        merged = got + got
        assert merged.result() == (got.result()[0], 2 * got.result()[1])


# ---- the learning rate as a tensor --------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(momentum=0.9, dampening=0.0),
                                dict(momentum=0.9, dampening=0.0,
                                     nesterov=True, weight_decay=1e-3),
                                dict(learning_rate_decay=0.37)])
def test_sgd_with_its_lr_in_a_tensor_equals_the_float_path(kw):
    gen = torch.Generator().manual_seed(1)
    params = [torch.randn(5, 7, generator=gen), torch.randn(7, generator=gen)]
    twin = [p.clone() for p in params]
    sgd = SGD(0.173, **kw)
    a, b = sgd.init_state(params), sgd.init_state(twin)
    lr_t = torch.zeros(())
    for step in range(5):
        grads = [torch.randn(p.shape, generator=gen) for p in params]
        sgd.update(grads, params, a, epoch=1)
        lr = sgd.current_lr(b, epoch=1)
        lr_t.fill_(lr)
        sgd.apply(grads, twin, b, lr_t)
        b["t"] += 1
        for p, q in zip(params, twin):
            assert torch.equal(p, q), step
    assert a["t"] == b["t"] == 5
    assert Default(0.37)(0.173, 3, 1) == sgd.current_lr({"t": 3}) \
        if "learning_rate_decay" in kw else True


# ---- set_iterations_per_dispatch: tests/test_dispatch_window.py's cases

def _train(k, epochs=2, data=None, end=None, **setters):
    _, model = _pair()
    opt = (Optimizer(model, data or _pipeline("port"),
                     pnn.ClassNLLCriterion())
           .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
           .set_end_when(end or Trigger.max_epoch(epochs))
           .set_iterations_per_dispatch(k))
    for name, args in setters.items():
        getattr(opt, name)(*args)
    opt.optimize()
    return model, opt


def test_window_matches_single_step():
    m1, o1 = _train(1)
    m4, o4 = _train(4)
    for p, q in zip(m1.parameters(), m4.parameters()):
        assert torch.equal(p, q)
    assert o4.loss_history == o1.loss_history
    assert o1.dispatch_stats["window_steps"] == 0
    assert o4.dispatch_stats == {"single_steps": 0, "window_steps": 16,
                                 "captures": 0, "replays": 0}


def test_window_ragged_tail_and_counts():
    """8 batches an epoch with k=3: windows of 3 + 3, then 2 single
    steps, each epoch; the iteration and record counts of k=1."""
    m3, o3 = _train(3)
    m1, o1 = _train(1)
    assert o3.state["neval"] == o1.state["neval"] == 17
    assert o3.state["records"] == o1.state["records"]
    assert o3.dispatch_stats["window_steps"] == 12
    assert o3.dispatch_stats["single_steps"] == 4
    for p, q in zip(m1.parameters(), m3.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("k,window_steps", [(3, 6), (4, 0)])
def test_window_trigger_alignment(k, window_steps):
    """A several_iteration(3) validation fires on iterations 3, 6, 9 with
    k windows as with k=1: a window is trimmed to end where the trigger
    fires, and a trimmed window runs single steps (with k=4 every window
    is trimmed, as the reference's: pick k dividing trigger periods)."""
    runs = {}
    for kk in (1, k):
        runs[kk] = _train(kk, epochs=1, set_validation=(
            Trigger.several_iteration(3), _pipeline("port", 64, 32, 7),
            [Top1Accuracy()]))
    for kk, (_, opt) in runs.items():
        assert [n for n, _ in opt.validation_history] == [3, 6, 9], kk
    assert runs[k][1].dispatch_stats["window_steps"] == window_steps
    assert runs[k][1].dispatch_stats["single_steps"] == 8 - window_steps
    for p, q in zip(runs[1][0].parameters(), runs[k][0].parameters()):
        assert torch.equal(p, q)


def test_window_validation_score():
    """Windowed dispatch composes with every-epoch validation; the model
    learns."""
    _, opt = _train(4, epochs=3, data=_pipeline("port", 512, 64),
                    set_validation=(Trigger.every_epoch(),
                                    _pipeline("port", 256, 64, seed=7),
                                    [Top1Accuracy()]))
    assert opt.state["score"] > 0.8
    assert [n for n, _ in opt.validation_history] == [9, 17, 25]


@pytest.mark.parametrize("shuffle", [False, True])
def test_window_device_cached_data(shuffle):
    data = DataSet.array(synthetic_mnist(256, seed=0), shuffle=shuffle,
                         seed=5 if shuffle else None) \
        .transform(GreyImgNormalizer(128.0, 128.0)) \
        .transform(SampleToMiniBatch(32)).cache_on_device("cpu")
    m4, o4 = _train(4, data=data)
    assert o4.state["neval"] == 17  # 8 batches x 2 epochs + 1
    if not shuffle:
        m1, _ = _train(1)
        for p, q in zip(m1.parameters(), m4.parameters()):
            assert torch.equal(p, q)


def test_window_min_loss_trigger_forces_single_step():
    """A loss-reading end trigger cannot be windowed: the loop takes
    single steps and stops on the iteration the loss crosses."""
    _, opt = _train(4, end=Trigger.or_(Trigger.max_epoch(50),
                                       Trigger.min_loss(1.5)))
    assert opt.state["loss"] < 1.5
    assert opt.dispatch_stats["window_steps"] == 0
    # stopped on the crossing iteration, not at a window's end
    losses = [loss for _, loss in opt.loss_history]
    assert losses[-1] < 1.5 and all(x >= 1.5 for x in losses[:-1])


def test_ragged_batch_shapes_take_single_steps():
    """40 samples at batch 16: one window of k=2 at batch 16 and a
    ragged batch of 8 down the single-step path, every epoch."""
    data = DataSet.array(synthetic_mnist(40, seed=0), shuffle=False) \
        .transform(GreyImgNormalizer(128.0, 128.0)) \
        .transform(SampleToMiniBatch(16, drop_last=False))
    _, opt = _train(2, epochs=3, data=data)
    assert opt.state["neval"] == 10
    assert opt.state["loss"] < 2.5
    assert opt.dispatch_stats["window_steps"] == 6
    assert opt.dispatch_stats["single_steps"] == 3


def test_window_with_dropout_reseeds_each_step():
    """A train-mode dropout inside windows draws the stream of k=1: the
    generator is reseeded per iteration, inside a window too."""

    class Drop(pnn.Module):
        def forward(self, x):
            from bigdl_tpu_torch.core.module import dropout
            return dropout(x, 0.3) if self.training else x

    def run(k):
        gen = torch.Generator().manual_seed(0)
        model = pnn.Sequential(
            pnn.Flatten(), pnn.Linear(784, 32, generator=gen, device="cpu"),
            Drop(), pnn.Tanh(),
            pnn.Linear(32, 10, generator=gen, device="cpu"),
            pnn.LogSoftMax())
        Optimizer(model, _pipeline("port"), pnn.ClassNLLCriterion(),
                  seed=11).set_optim_method(SGD(0.1)) \
            .set_end_when(Trigger.max_epoch(1)) \
            .set_iterations_per_dispatch(k).optimize()
        return model
    a, b = run(1), run(4)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    with forward_context(generator=torch.Generator().manual_seed(0)):
        assert Drop().train()(torch.ones(100)).eq(0).any()


def test_setters_of_the_second_half_chain():
    _, port = _pair()
    opt = Optimizer(port, _pipeline("port"), pnn.ClassNLLCriterion())
    assert opt.set_device_prefetch(2) is opt
    assert opt.device_prefetch_ahead == 2
    assert opt.set_device_prefetch(0).device_prefetch_ahead is None
    with pytest.raises(ValueError, match="n_ahead"):
        opt.set_device_prefetch(-1)
    assert opt.set_checkpoint("ckpt", Trigger.every_epoch()) is opt
    assert opt.resume("ckpt/checkpoint.npz") is opt
    assert opt.set_failure_retry(2) is opt
    assert opt.disable_gradient_clipping() is opt


def test_transformer_chain_matches_reference():
    """``a >> b`` chains, Identity and FeatureLabelTransformer, then
    GreyImgNormalizer and SampleToMiniBatch, over the same synthetic
    digits in both packages."""
    from bigdl_tpu.dataset import transformer as jt
    from bigdl_tpu_torch.dataset import FeatureLabelTransformer, Identity
    ref = (jt.Identity() >> jt.FeatureLabelTransformer(
        lambda f: f[::-1], lambda l: l + 1) >> JGrey(100.0, 50.0)
        >> JSampleToMiniBatch(8))
    port = (Identity() >> FeatureLabelTransformer(
        lambda f: f[::-1], lambda l: l + 1) >> GreyImgNormalizer(100.0, 50.0)
        >> SampleToMiniBatch(8))
    want = list(ref(iter(j_synthetic_mnist(20, seed=2))))
    got = list(port(iter(synthetic_mnist(20, seed=2))))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.get_input(), w.get_input())
        np.testing.assert_array_equal(g.get_target(), w.get_target())


def test_assigned_buffers_keep_their_storage_and_saved_values():
    """A buffer the forward assigns (as BatchNorm's running statistics)
    is copied into its storage after the backward, in float32 and in
    bfloat16: an autograd Function that saved the old value (as the
    fused conv+BN's saves its shift) still finds it unchanged, and the
    buffer object stays the one a captured graph reads."""

    class Shift(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(k)
            return x - k

        @staticmethod
        def backward(ctx, g):
            (k,) = ctx.saved_tensors
            return g + 0 * k, None

    class Shifted(pnn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("k", torch.zeros(784))
            self.scale = torch.nn.Parameter(torch.ones(784))

        def forward(self, x):
            # the Function is on the gradient's path (a parameter feeds it)
            y = Shift.apply(x.reshape(x.shape[0], -1) * self.scale,
                            self.k.detach())
            self.k = 0.9 * self.k + 0.1 * x.reshape(x.shape[0], -1) \
                .mean(0).detach().to(self.k.dtype)
            return y

    for dtype in (None, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        model = pnn.Sequential(Shifted(), pnn.Linear(784, 10, generator=gen,
                                                     device="cpu"),
                               pnn.LogSoftMax())
        k = model.layers[0].k
        opt = Optimizer(model, _pipeline("port", 64, 32),
                        pnn.ClassNLLCriterion()) \
            .set_end_when(Trigger.max_iteration(2)).set_compute_dtype(dtype)
        opt.optimize()
        assert model.layers[0].k is k and k.dtype == torch.float32
        x = [b.get_input() for b in _pipeline("port", 64, 32).data()]
        want = torch.zeros(784)
        for xb in x:
            xb = torch.tensor(xb)
            if dtype is not None:
                want, xb = want.to(dtype), xb.to(dtype)
            want = (0.9 * want + 0.1 * xb.reshape(32, -1).mean(0)).float()
        torch.testing.assert_close(k, want, rtol=0, atol=0)
