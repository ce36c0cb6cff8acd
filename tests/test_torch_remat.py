"""``TransformerLM(remat=True)``: each block recomputed in the backward,
its dropout masks drawn again from the stream the forward drew them from
(``core.module.recompute``).

* The port's remat LM against the port's plain LM, dropout 0.1 (the
  attention's too on the dense path; the ring refuses attention dropout,
  so the SP path drops out after the attention and in the FFN), at L2
  H32: the loss and every gradient of one ``Optimizer`` step, and the
  losses and parameters of a 20-step run, equal bit for bit (the
  recompute runs the forward's operations on the forward's inputs, and
  the backward is the plain LM's graph), dense in f32 and bf16 and on a
  2-shard ``seq`` mesh.  A recompute that draws a fresh stream instead
  is told apart.
* The port's remat LM against the reference's remat LM (``jax.checkpoint``
  per block) at the same weights, dropout 0: loss and gradients within
  tests/test_torch_transformer_lm.py's tolerance, atol 1e-4.
* A recompute outside any ``forward_context`` does not raise.
* ``perf --remat`` trains on the CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.core import module as core_module
from bigdl_tpu_torch.core.module import forward_context
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.examples import perf
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.parallel import make_mesh

VOCAB, T, B = 50, 16, 4
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
           filter_size=64, max_len=T)
ATOL = 1e-4   # tests/test_torch_transformer_lm.py's


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [MiniBatch(rng.integers(1, VOCAB + 1, (B, T)).astype(np.int32),
                      rng.integers(1, VOCAB + 1, (B * T,)).astype(np.int32))
            for _ in range(n)]


def _lm(remat, path, dropout=0.1):
    lm = transformer_lm(**CFG, dropout=dropout, remat=remat,
                        padded_inputs=path == "dense",
                        generator=torch.Generator().manual_seed(1),
                        device="cpu")
    if path == "sp":
        for blk in lm.blocks:
            blk.self_attn.attention_dropout = 0.0
        lm.set_sequence_parallel(make_mesh({"seq": 2}, ["cpu"] * 2), "seq")
    return FlatLM(lm)


def _run(remat, path, steps, dtype=None):
    model = _lm(remat, path)
    opt = (Optimizer(model, DataSet.array(_batches(4), shuffle=False),
                     CrossEntropyCriterion(), seed=3)
           .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
           .set_end_when(Trigger.max_iteration(steps))
           .set_log_interval(4)
           .set_compute_dtype(dtype))
    opt.optimize()
    return opt, model


CASES = [("dense", None), ("dense", torch.bfloat16), ("sp", None)]


@pytest.mark.parametrize("path,dtype", CASES)
def test_remat_step_equals_plain_step_bit_for_bit(path, dtype):
    plain, pm = _run(False, path, 1, dtype)
    remat, rm = _run(True, path, 1, dtype)
    assert remat.loss_history == plain.loss_history
    for (name, p), q in zip(pm.named_parameters(), rm.parameters()):
        assert p.grad is not None and torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("path,dtype", CASES)
def test_remat_run_equals_plain_run_bit_for_bit(path, dtype):
    plain, pm = _run(False, path, 20, dtype)
    remat, rm = _run(True, path, 20, dtype)
    assert len(plain.loss_history) == 20
    assert remat.loss_history == plain.loss_history
    for (name, p), q in zip(pm.named_parameters(), rm.parameters()):
        assert torch.equal(p, q), name


def test_a_recompute_drawing_a_fresh_stream_is_told_apart(monkeypatch):
    """The same run with the recompute drawing from the generator as it
    stands after the forward: its masks differ, and so does the step."""
    plain, pm = _run(False, "dense", 1)
    monkeypatch.setattr(core_module, "_replay_generator", lambda g: g)
    remat, rm = _run(True, "dense", 1)
    assert remat.loss_history == plain.loss_history  # the forward's own
    assert not all(torch.equal(p.grad, q.grad)
                   for p, q in zip(pm.parameters(), rm.parameters()))


def test_recompute_outside_the_forward_context():
    """The Optimizer's backward runs after its forward_context exits: the
    recompute needs no generator in scope, and the gradients are the
    plain LM's."""
    x = torch.as_tensor(_batches(1)[0].get_input())
    grads = []
    for remat in (False, True):
        model = _lm(remat, "dense").train()
        with forward_context(generator=torch.Generator().manual_seed(5)):
            out = model(x)
        out.float().square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_lm_matches_the_reference_remat_lm():
    set_seed(0)
    ref = jax_transformer_lm(**CFG, remat=True).train_mode()
    params = jax.tree_util.tree_map(np.asarray, ref.parameters())
    port = load_jax_parameters(_lm(True, "dense", dropout=0.0).lm, params)
    port.train()
    batch = _batches(1, seed=4)[0]
    toks, y = batch.get_input(), batch.get_target()
    crit = jnn.CrossEntropyCriterion()
    jparams, rest = partition(ref)

    def loss_of(p):
        out = combine(p, rest).forward(jnp.asarray(toks))
        return crit(out.reshape(-1, VOCAB + 1), jnp.asarray(y))

    want_loss, want = jax.value_and_grad(loss_of)(jparams)
    want = flatten_jax_parameters(
        jax.tree_util.tree_map(np.asarray, want.parameters()))
    with forward_context(generator=torch.Generator()):
        logits = port(toks)
    loss = CrossEntropyCriterion()(logits.reshape(-1, VOCAB + 1),
                                   torch.as_tensor(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=ATOL, rtol=0)
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_perf_cli_trains_with_remat():
    argv = ["--model", "transformer-lm", "--seq-len", "16", "-b", "4",
            "--hidden-size", "32", "--num-layers", "2", "--num-heads", "4",
            "--vocab-size", "50", "--iterations", "2", "--epochs", "3",
            "--device", "cpu", "--remat"]
    out, opt = perf.train(perf.parse_args(argv))
    assert opt.model.lm.remat and out["windows_timed"] == 2
    losses = [loss for _, loss in opt.loss_history]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
