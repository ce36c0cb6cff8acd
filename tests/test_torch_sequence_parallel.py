"""The port's sequence-parallel TransformerLM (``set_sequence_parallel``:
every block's self-attention through ring attention) against the JAX
package's, with the reference's weights carried across by
``load_jax_parameters``:

* logits and the gradient of every parameter, by name, on a 4-shard
  ``seq`` mesh with ``kernel="flash"`` on both sides (the reference's
  Pallas partial kernels in interpret mode; the port's autograd Function
  over their plain versions on CPU tensors), at the reference's own
  bounds (tests/test_transformer_lm.py:311 and :338): logits rtol 2e-4,
  atol 2e-5; gradients rtol 5e-4, atol 1e-5;
* the swap shares the projection modules, reconfigures in place, and
  refuses what the reference refuses;
* three f32 Optimizer steps, ring against dense, in the port: losses
  within 1e-5 relative (the same sums but for the attention's order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.nn.attention import Attention
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.parallel import RingSelfAttention, make_mesh
from bigdl_tpu_torch.serving.generation import SlotPool

VOCAB = 50
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
           filter_size=64, max_len=64)
LOGITS = dict(rtol=2e-4, atol=2e-5)
GRADS = dict(rtol=5e-4, atol=1e-5)
LOSS_RTOL = 1e-5


def _port(**kw):
    return transformer_lm(**CFG, **kw,
                          generator=torch.Generator().manual_seed(1),
                          device="cpu")


def _pair():
    set_seed(0)
    ref = jax_transformer_lm(**CFG).eval_mode()
    params = jax.tree_util.tree_map(np.asarray, ref.parameters())
    return ref, load_jax_parameters(_port().eval(), params)


def _cpu_mesh(n=4):
    return make_mesh({"seq": n}, ["cpu"] * n)


def test_sequence_parallel_lm_matches_reference():
    ref, port = _pair()
    rng = np.random.default_rng(11)
    toks = rng.integers(1, VOCAB + 1, (2, 32)).astype(np.int32)
    y = rng.integers(1, VOCAB + 1, (2 * 32,)).astype(np.int32)
    ref.set_sequence_parallel(
        JaxMesh(np.asarray(jax.devices()[:4]), ("seq",)), "seq",
        kernel="flash")
    port.set_sequence_parallel(_cpu_mesh(), "seq", kernel="flash")

    crit = jnn.CrossEntropyCriterion()
    params, rest = partition(ref)

    def loss_of(p):
        out = combine(p, rest).forward(jnp.asarray(toks))
        return crit(out.reshape(-1, VOCAB + 1), jnp.asarray(y)), out

    (_, want_logits), want = jax.value_and_grad(loss_of, has_aux=True)(
        params)
    want = flatten_jax_parameters(
        jax.tree_util.tree_map(np.asarray, want.parameters()))

    logits = port(toks)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **LOGITS)
    CrossEntropyCriterion()(logits.reshape(-1, VOCAB + 1),
                            torch.as_tensor(y).long()).backward()
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **GRADS,
                                   err_msg=name)


def test_plain_ring_lm_matches_dense():
    """kernel=None on CPU tensors runs the plain ring; it equals the dense
    causal forward."""
    port = _port(padded_inputs=False).eval()
    toks = np.random.default_rng(12).integers(1, VOCAB + 1, (2, 32))
    with torch.no_grad():
        dense = port(toks)
        port.set_sequence_parallel(_cpu_mesh())
        ring = port(toks)
    np.testing.assert_allclose(ring.numpy(), dense.numpy(), **LOGITS)


def test_swap_shares_weights_and_reconfigures_in_place():
    port = _port()
    names = [n for n, _ in port.named_parameters()]
    orig_q = port.blocks[0].self_attn.q_layer
    mesh = _cpu_mesh()
    port.set_sequence_parallel(mesh, "seq")
    ring = port.blocks[0].self_attn
    assert isinstance(ring, RingSelfAttention) and port.seq_parallel
    assert ring.q_layer is orig_q
    assert [n for n, _ in port.named_parameters()] == names
    mesh2 = _cpu_mesh(2)
    port.set_sequence_parallel(mesh2, "seq", kernel="plain")
    assert port.blocks[0].self_attn is ring
    assert ring.mesh is mesh2 and ring.ring_kernel == "plain"
    with pytest.raises(NotImplementedError, match="item 11"):
        port.set_sequence_parallel(mesh, "seq", head_axis="model")


def test_ring_routes_and_refusals():
    port = _port()
    mesh = _cpu_mesh()
    port.set_sequence_parallel(mesh)
    toks = np.random.default_rng(13).integers(1, VOCAB + 1, (2, 16))
    toks[1, -3:] = 0
    with pytest.raises(ValueError, match="sequence-parallel"):
        port(toks)
    ring = port.blocks[0].self_attn
    x = torch.randn(2, 16, 32)
    # a bias routes dense, with the causal mask folded in
    bias = torch.zeros(2, 1, 1, 16)
    with torch.no_grad():
        dense = Attention.forward(ring, x, None, None, causal=True)
        np.testing.assert_allclose(ring(x, bias=bias).numpy(),
                                   dense.numpy(), **LOGITS)
        # cross-attention routes dense
        y = torch.randn(2, 8, 32)
        np.testing.assert_allclose(ring(x, y).numpy(),
                                   Attention.forward(ring, x, y).numpy(),
                                   **LOGITS)
    with pytest.raises(ValueError, match="not divisible"):
        ring(torch.randn(2, 18, 32))
    with pytest.raises(ValueError, match="cache/cross"):
        ring(x, y, causal=True)
    non_causal = RingSelfAttention.from_attention(ring, mesh, causal=False)
    with pytest.raises(ValueError, match="causal=False"):
        non_causal(x, causal=True)
    dropping = RingSelfAttention(32, 4, mesh, attention_dropout=0.1,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match="attention dropout"):
        dropping(x)
    dropping.eval()
    assert dropping(x).shape == (2, 16, 32)
    with pytest.raises(ValueError, match="sequence-parallel models"):
        SlotPool(port, slots=1, device="cpu")


def test_sequence_parallel_generation_falls_back_to_dense():
    """Incremental decoding keeps working after the swap: the cache path
    routes dense."""
    port = _port().eval()
    prompt = np.random.default_rng(14).integers(1, VOCAB + 1, (2, 5))
    want = port.generate(prompt, 6)
    port.set_sequence_parallel(_cpu_mesh())
    assert torch.equal(port.generate(prompt, 6), want)


def _optimizer_losses(sequence_parallel: bool):
    lm = _port(padded_inputs=False)
    if sequence_parallel:
        lm.set_sequence_parallel(_cpu_mesh(), kernel="flash")
    rng = np.random.default_rng(15)
    batches = [MiniBatch(rng.integers(1, VOCAB + 1, (2, 32)),
                         rng.integers(1, VOCAB + 1, (64,)))
               for _ in range(3)]
    opt = (Optimizer(FlatLM(lm), DataSet.array(batches, shuffle=False),
                     CrossEntropyCriterion(), seed=0)
           .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
           .set_end_when(Trigger.max_iteration(3)))
    opt.optimize()
    return [loss for _, loss in opt.loss_history]


def test_optimizer_steps_ring_match_dense():
    dense = _optimizer_losses(False)
    ring = _optimizer_losses(True)
    assert len(ring) == 3 and dense[-1] < dense[0]
    np.testing.assert_allclose(ring, dense, rtol=LOSS_RTOL, atol=0)


# ---- one f32 step, ring against dense, in both packages ---------------------

def _step_updates(sequence_parallel: bool):
    """One f32 SGD step of the reference's LM and of the port's, from the
    same weights (load_jax_parameters) and batch, dense or through the
    ring on an 8-shard seq mesh: (reference loss, {name: reference
    update}, port loss, {name: port update})."""
    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
    from bigdl_tpu.examples.perf import _flat_lm
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Trigger as JTrigger
    set_seed(0)
    ref_lm = jax_transformer_lm(**CFG, padded_inputs=False)
    port_lm = _port(padded_inputs=False)
    load_jax_parameters(port_lm, jax.tree_util.tree_map(
        np.asarray, ref_lm.parameters()))
    if sequence_parallel:
        # all 8 CPU devices: the reference's Optimizer places its
        # parameters on every device, and the ring's shard_map must match
        ref_lm.set_sequence_parallel(
            JaxMesh(np.asarray(jax.devices()[:8]), ("seq",)), "seq",
            kernel="flash")
        port_lm.set_sequence_parallel(_cpu_mesh(8), "seq", kernel="flash")
    ref, port = _flat_lm(ref_lm), FlatLM(port_lm)
    before_ref = flatten_jax_parameters(ref_lm.parameters())
    before_port = {n: p.detach().clone()
                   for n, p in port_lm.named_parameters()}
    rng = np.random.default_rng(16)
    # batch 8: the reference's Optimizer splits it over its 8 CPU devices
    x = rng.integers(1, VOCAB + 1, (8, 32)).astype(np.int32)
    y = rng.integers(1, VOCAB + 1, (8 * 32,)).astype(np.int32)
    ref_opt = (JOptimizer(ref, JDataSet.array([JMiniBatch(x, y)],
                                              shuffle=False),
                          jnn.CrossEntropyCriterion())
               .set_optim_method(JSGD(0.1, momentum=0.9, dampening=0.0))
               .set_end_when(JTrigger.max_iteration(1)))
    port_opt = (Optimizer(port, DataSet.array([MiniBatch(x, y)],
                                              shuffle=False),
                          CrossEntropyCriterion(), seed=0)
                .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
                .set_end_when(Trigger.max_iteration(1)))
    ref_opt.optimize()
    port_opt.optimize()
    after_ref = flatten_jax_parameters(ref_lm.parameters())
    return (float(ref_opt.state["loss"]),
            {n: after_ref[n] - before_ref[n] for n in before_ref},
            port_opt.loss_history[0][1],
            {n: (p.detach() - before_port[n]).numpy()
             for n, p in port_lm.named_parameters()})


def _gap(ring, dense):
    """(relative loss gap, worst update gap in norm, its parameter) of a
    ring step against the dense one."""
    (loss_r, upd_r), (loss_d, upd_d) = ring, dense
    norms = {n: float(np.linalg.norm(upd_r[n] - upd_d[n])
                      / max(np.linalg.norm(upd_d[n]), 1e-30))
             for n in upd_d}
    worst = max(norms, key=norms.get)
    return abs(loss_r - loss_d) / abs(loss_d), norms[worst], worst


def test_one_step_ring_against_dense_in_both_packages():
    """One f32 Optimizer step, ring against dense, in the reference and
    in the port from the same weights: both gaps (loss, and each
    parameter's update in norm) sit at f32 rounding, far under the card's
    bounds (loss 1e-5, updates 1e-3), and the port's is no larger than
    the reference's beyond f32 noise (ROADMAP.md queue 3 records both)."""
    ring_ref_loss, ring_ref, ring_port_loss, ring_port = _step_updates(True)
    dense_ref_loss, dense_ref, dense_port_loss, dense_port = \
        _step_updates(False)
    ref_gap = _gap((ring_ref_loss, ring_ref), (dense_ref_loss, dense_ref))
    port_gap = _gap((ring_port_loss, ring_port),
                    (dense_port_loss, dense_port))
    print(f"ring vs dense, one f32 step: reference loss {ref_gap[0]:.3e}, "
          f"update {ref_gap[1]:.3e} ({ref_gap[2]}); port loss "
          f"{port_gap[0]:.3e}, update {port_gap[1]:.3e} ({port_gap[2]})")
    for loss_gap, upd_gap, _ in (ref_gap, port_gap):
        assert loss_gap <= LOSS_RTOL and upd_gap <= 1e-3
    assert port_gap[1] <= max(4 * ref_gap[1], 1e-5)
