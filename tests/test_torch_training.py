"""The port's training loop against the JAX package's, on the same numpy
inputs and bridged weights: the criteria, SGD's update rule, the
triggers and the epoch order, the Optimizer on a small TransformerLM,
and the dropout repair (train-mode dropout draws from the forward
context's generator, never from torch's global RNG).

Tolerances: criteria and SGD float32 rtol 1e-5, atol 1e-6 (one
operation order apart).  The Optimizer in float32: rtol 1e-4, atol 1e-5
on every parameter after 6 SGD steps -- the reference runs its step as
an SPMD program over 8 CPU devices, so its sums go in another order
through a few layers and the momentum carries the difference (the gap
measured on the CPU is about 1e-7).  With bf16 compute: atol 5e-3 on the
parameters and 1e-2 on the loss -- the frameworks round a bf16 layer
norm and softmax at other points; measured on the CPU, the parameters
differ by at most 9e-4 after moving by up to 0.21, and the losses (near
4.3) by 1e-3.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.dataset.dataset import epoch_permutation as j_epoch_perm
from bigdl_tpu.examples.perf import _flat_lm
from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.core.module import forward_context, next_generator
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, epoch_permutation
from bigdl_tpu_torch.examples import perf
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.nn import attention as port_attention
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion, \
    CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

EXACT = dict(rtol=1e-5, atol=1e-6)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- criteria ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"size_average": False}, {"weights": "w"},
    {"weights": "w", "size_average": False}])
def test_cross_entropy_matches_reference(kw):
    x = rnd(12, 7, seed=1)
    y = np.random.RandomState(2).randint(1, 8, 12).astype(np.int32)
    if kw.get("weights") == "w":
        kw = dict(kw, weights=np.linspace(0.5, 2.0, 7).astype(np.float32))
    want = float(jnn.CrossEntropyCriterion(**kw)(jnp.asarray(x),
                                                  jnp.asarray(y)))
    xt = torch.tensor(x, requires_grad=True)
    got = CrossEntropyCriterion(**kw)(xt, y)
    np.testing.assert_allclose(float(got.detach()), want, **EXACT)
    gx = jax.grad(lambda a: jnn.CrossEntropyCriterion(**kw)(
        a, jnp.asarray(y)))(jnp.asarray(x))
    got.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **EXACT)


@pytest.mark.parametrize("kw", [
    {"paddingValue": 3}, {"paddingValue": 3, "weights": "w"},
    {"paddingValue": 3, "size_average": False},
    {"logProbAsInput": False}])
def test_class_nll_matches_reference(kw):
    logits = rnd(10, 5, seed=3)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    x = np.exp(logp) if kw.get("logProbAsInput") is False else logp
    y = np.array([1, 3, 5, 3, 2, 4, 3, 1, 5, 2], np.int32)
    if kw.get("weights") == "w":
        kw = dict(kw, weights=np.arange(1, 6, dtype=np.float32))
    want = float(jnn.ClassNLLCriterion(**kw)(jnp.asarray(x),
                                             jnp.asarray(y)))
    got = float(ClassNLLCriterion(**kw)(torch.tensor(x), y))
    np.testing.assert_allclose(got, want, **EXACT)


# ---- SGD ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1),
    dict(learning_rate=0.1, momentum=0.9, dampening=0.0),
    dict(learning_rate=0.05, momentum=0.9),
    dict(learning_rate=0.05, momentum=0.8, dampening=0.0, nesterov=True),
    dict(learning_rate=0.1, weight_decay=0.01, momentum=0.5,
         learning_rate_decay=0.3),
])
def test_sgd_update_matches_reference(kw):
    shapes = [(4, 3), (5,)]
    params = [rnd(*s, seed=i) for i, s in enumerate(shapes)]
    ref, port = JSGD(**kw), SGD(**kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    js, ts = ref.init_state(jp), port.init_state(tp)
    for step in range(4):
        grads = [rnd(*s, seed=10 * step + i) for i, s in enumerate(shapes)]
        jp, js = ref.update([jnp.asarray(g) for g in grads], jp, js, 1)
        out, ts = port.update([torch.tensor(g) for g in grads], tp, ts, 1)
        assert out is tp                      # updated in place
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EXACT)
    assert ts["t"] == int(js["t"]) == 4


def test_sgd_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="Nesterov"):
        SGD(0.1, momentum=0.9, nesterov=True)
    # every schedule is ported now: SGD takes any, and reads its rate
    from bigdl_tpu_torch.optim.methods import Poly
    sgd = SGD(0.1, learning_rate_schedule=Poly(0.5, 10))
    assert sgd.current_lr({"t": 4}) == Poly(0.5, 10)(0.1, 4, 0)


# ---- triggers and epoch order ----------------------------------------------

def test_triggers_and_epoch_permutation_match_exactly():
    states = [{"epoch": e, "neval": n, "loss": l, "score": s,
               "is_epoch_end": end}
              for e in (1, 3) for n in (1, 4, 9) for l in (0.5, 2.0)
              for s in (0.1, 0.9) for end in (False, True)]
    pairs = [(JTrigger.max_epoch(2), Trigger.max_epoch(2)),
             (JTrigger.max_iteration(4), Trigger.max_iteration(4)),
             (JTrigger.every_epoch(), Trigger.every_epoch()),
             (JTrigger.several_iteration(3), Trigger.several_iteration(3)),
             (JTrigger.max_score(0.5), Trigger.max_score(0.5)),
             (JTrigger.min_loss(1.0), Trigger.min_loss(1.0)),
             (JTrigger.and_(JTrigger.max_epoch(2), JTrigger.min_loss(1.0)),
              Trigger.and_(Trigger.max_epoch(2), Trigger.min_loss(1.0))),
             (JTrigger.or_(JTrigger.every_epoch(),
                           JTrigger.max_iteration(4)),
              Trigger.or_(Trigger.every_epoch(), Trigger.max_iteration(4)))]
    for ref, port in pairs:
        assert [ref(s) for s in states] == [port(s) for s in states]
        assert ref.needs_loss == port.needs_loss and ref.name == port.name
    for n, seed, epoch in ((10, 0, 1), (37, 7, 3), (1000, 2 ** 40, 12)):
        np.testing.assert_array_equal(epoch_permutation(n, seed, epoch),
                                      j_epoch_perm(n, seed, epoch))
    items = list(range(9))
    ref_ds = JDataSet.array(items, shuffle=True, seed=5)
    port_ds = DataSet.array(items, shuffle=True, seed=5)
    for epoch in (1, 2, 3):
        assert list(port_ds.data(epoch=epoch)) == list(
            ref_ds.data(epoch=epoch))
    with pytest.raises(ValueError, match="explicit seed"):
        DataSet.array(items, shuffle=True)


def test_device_cache_copies_a_shared_buffer_once():
    x = np.arange(12).reshape(3, 4)
    ds = DataSet.array([MiniBatch(x, x[:, 0])] * 3, shuffle=False) \
        .cache_on_device("cpu")
    batches = list(ds.data(epoch=1))
    assert len(batches) == 3 and batches[0].get_input() is \
        batches[2].get_input()
    assert torch.is_tensor(batches[1].get_target())
    np.testing.assert_array_equal(batches[1].get_input().numpy(), x)


# ---- the Optimizer against the reference's ---------------------------------

LM_CFG = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4,
              filter_size=64, max_len=16)
BATCH, SEQ, N_BATCHES, EPOCHS, DATA_SEED = 16, 16, 3, 2, 11


def _batches(padded):
    rng = np.random.default_rng(6)
    out = []
    for _ in range(N_BATCHES):
        x = rng.integers(1, LM_CFG["vocab_size"] + 1,
                         (BATCH, SEQ)).astype(np.int32)
        if padded:
            x[-3:, 12:] = 0                  # trailing padding
        y = rng.integers(1, LM_CFG["vocab_size"] + 1,
                         (BATCH * SEQ,)).astype(np.int32)
        out.append((x, y))
    return out


def _train_both(padded, bf16):
    set_seed(0)
    ref = _flat_lm(jax_transformer_lm(**LM_CFG, padded_inputs=padded))
    port = FlatLM(transformer_lm(**LM_CFG, padded_inputs=padded,
                                 generator=torch.Generator().manual_seed(1),
                                 device="cpu"))
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    data = _batches(padded)

    def configure(opt, sgd, trigger):
        opt.set_optim_method(sgd(0.1, momentum=0.9, dampening=0.0)) \
            .set_end_when(trigger.max_epoch(EPOCHS)).set_log_interval(2)
        return opt

    ref_opt = configure(JOptimizer(
        ref, JDataSet.array([JMiniBatch(x, y) for x, y in data],
                            shuffle=True, seed=DATA_SEED),
        jnn.CrossEntropyCriterion()), JSGD, JTrigger)
    port_opt = configure(Optimizer(
        port, DataSet.array([MiniBatch(x, y) for x, y in data],
                            shuffle=True, seed=DATA_SEED),
        CrossEntropyCriterion()), SGD, Trigger)
    if bf16:
        ref_opt.set_compute_dtype(jnp.bfloat16)
        port_opt.set_compute_dtype(torch.bfloat16)
    ref_opt.optimize()
    port_opt.optimize()
    return ref, port, ref_opt, port_opt


@pytest.mark.parametrize("padded,bf16", [(True, False), (False, False),
                                         (False, True)])
def test_optimizer_matches_reference(padded, bf16):
    ref, port, ref_opt, port_opt = _train_both(padded, bf16)
    for key in ("neval", "epoch", "records", "is_epoch_end"):
        assert port_opt.state[key] == ref_opt.state[key], key
    assert port_opt.state["neval"] == N_BATCHES * EPOCHS + 1
    assert [n for n, _, _ in port_opt.window_timings] == \
        [n for n, _, _ in ref_opt.window_timings]
    tol = dict(rtol=1e-4, atol=1e-5) if not bf16 else dict(rtol=0,
                                                            atol=5e-3)
    loss_tol = dict(rtol=1e-4) if not bf16 else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(port_opt.state["loss"],
                               ref_opt.state["loss"], **loss_tol)
    want = flatten_jax_parameters(ref.parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], **tol,
                                   err_msg=name)
    losses = [loss for _, loss in port_opt.loss_history]
    assert len(losses) == N_BATCHES * EPOCHS and np.isfinite(losses).all()


def test_bf16_compute_casts_buffers_and_keeps_f32_masters():
    """The position table (a buffer) is cast with the parameters, so the
    whole forward runs in bf16 (an f32 buffer would promote the sum
    after the embedding back to f32); the masters stay f32."""
    lm = transformer_lm(**LM_CFG, generator=torch.Generator().manual_seed(2),
                        device="cpu")
    model = FlatLM(lm)
    seen = []
    hook = lm.blocks[0].self_attn.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    data = DataSet.array([MiniBatch(*_batches(False)[0])], shuffle=False)
    opt = Optimizer(model, data, CrossEntropyCriterion()) \
        .set_compute_dtype(torch.bfloat16)
    opt.optimize()
    hook.remove()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert lm.pos_table.dtype == torch.float32


def test_optimizer_refuses_what_the_slice_does_not_port():
    model = FlatLM(transformer_lm(**LM_CFG, device="cpu",
                                  generator=torch.Generator()))
    opt = Optimizer(model, DataSet.array([], shuffle=False),
                    CrossEntropyCriterion())
    for name in ("set_mesh", "set_partition_plan", "set_health_watchdog",
                 "set_train_summary"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(opt, name)(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.set_checkpoint("ckpt", Trigger.every_epoch(), sharded=True)
    # batch_size= batches raw samples now; an empty list has no batches
    with pytest.raises(ValueError, match="no batches"):
        Optimizer(model, [], CrossEntropyCriterion(), batch_size=4) \
            .optimize()
    with pytest.raises(ValueError, match="compute dtype"):
        opt.set_compute_dtype(torch.float16)
    with pytest.raises(ValueError, match="no batches"):
        opt.optimize()


def test_min_loss_trigger_reads_every_loss():
    model = FlatLM(transformer_lm(**LM_CFG, device="cpu",
                                  generator=torch.Generator().manual_seed(3)))
    data = DataSet.array([MiniBatch(x, y) for x, y in _batches(False)],
                         shuffle=False)
    opt = Optimizer(model, data, CrossEntropyCriterion()) \
        .set_optim_method(SGD(0.5)).set_log_interval(3) \
        .set_end_when(Trigger.or_(Trigger.min_loss(0.0),
                                  Trigger.max_iteration(4)))
    opt.optimize()
    # per-iteration readback: one window per iteration despite interval 3
    assert [n for n, _, _ in opt.window_timings] == [1] * 4
    assert opt.state["neval"] == 5 and opt.state["epoch"] == 3


# ---- perf CLI ---------------------------------------------------------------

PERF_ARGV = ["--model", "transformer-lm", "--seq-len", "16", "-b", "4",
             "--hidden-size", "32", "--num-layers", "2", "--num-heads", "4",
             "--vocab-size", "50", "--iterations", "2", "--epochs", "3",
             "--device", "cpu"]


def test_perf_cli_trains_and_reports_the_reference_keys(capsys):
    out = perf.main(PERF_ARGV)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith("{") and '"records_per_sec"' in printed
    assert set(out) == {"model", "batch_size", "records_per_sec",
                        "ms_per_iteration", "windows_timed",
                        "compile_plus_first_window_s", "bf16"}
    assert out["windows_timed"] == 2 and out["records_per_sec"] > 0
    result, opt = perf.train(perf.parse_args(PERF_ARGV + ["--bf16"]))
    assert result["bf16"] and opt.compute_dtype == torch.bfloat16
    losses = [loss for _, loss in opt.loss_history]
    assert len(losses) == 6 and losses[-1] < losses[0]


@pytest.mark.parametrize("extra,match", [
    (["--input-pipeline", "images"], "--input-pipeline"),
    (["--real-jpeg-train", "8"], "--real-jpeg-train"),
    (["--generate", "4"], "--generate"),
])
def test_perf_cli_refuses_other_models_and_modes(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        perf.main(PERF_ARGV + extra, emit=False)


def test_perf_cli_trains_fused_resnet50_in_bf16():
    """``--model resnet50 --fused --bf16`` on the CPU: the reference's
    result keys, a falling loss, and BatchNorm statistics written back
    to float32 buffers."""
    argv = ["--model", "resnet50", "--fused", "--bf16", "-b", "2",
            "--image-size", "32", "--classes", "10", "--iterations", "2",
            "--epochs", "3", "--device", "cpu"]
    out, opt = perf.train(perf.parse_args(argv))
    assert set(out) == {"model", "batch_size", "records_per_sec",
                        "ms_per_iteration", "windows_timed",
                        "compile_plus_first_window_s", "bf16"}
    assert out["model"] == "resnet50" and out["bf16"]
    losses = [loss for _, loss in opt.loss_history]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    blk = opt.model.blocks[0]
    assert blk.fused and blk.bn1.running_mean.dtype == torch.float32
    assert float(blk.bn1.running_mean.abs().max()) > 0


# ---- the dropout repair ------------------------------------------------------

def test_train_mode_dropout_needs_a_generator_in_scope():
    x = torch.ones(64, 64)
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        port_attention._residual_dropout(x, 0.5, True)
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        next_generator()
    # eval mode and p = 0 draw nothing
    assert port_attention._residual_dropout(x, 0.5, False) is x
    assert port_attention._residual_dropout(x, 0.0, True) is x


def test_dropout_mask_follows_the_seed_and_keeps_at_rate():
    x = torch.ones(200, 250)
    p = 0.3

    def draw(seed):
        with forward_context(generator=torch.Generator().manual_seed(seed)):
            return port_attention._residual_dropout(x, p, True)

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept],
                                                        1 / (1 - p)))
    n = x.numel()
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sd   # binomial bounds
    # the global RNG is untouched by a draw
    state = torch.get_rng_state()
    draw(9)
    assert torch.equal(state, torch.get_rng_state())


def test_attention_and_ffn_dropout_in_a_training_step():
    """A train-mode LM with dropout trains through the Optimizer (which
    opens the context itself, one stream per iteration, from its seed)
    and the same seed gives the same run."""
    def run(seed):
        lm = transformer_lm(**LM_CFG, dropout=0.2, device="cpu",
                            generator=torch.Generator().manual_seed(4))
        data = DataSet.array([MiniBatch(x, y) for x, y in _batches(True)],
                             shuffle=False)
        opt = Optimizer(FlatLM(lm), data, CrossEntropyCriterion(),
                        seed=seed).set_optim_method(SGD(0.1))
        opt.optimize()
        return [loss for _, loss in opt.loss_history]

    first = run(0)
    assert first == run(0) and first != run(1)
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        lm = transformer_lm(**LM_CFG, dropout=0.2, device="cpu",
                            generator=torch.Generator().manual_seed(4))
        lm.train()(_batches(True)[0][0])
