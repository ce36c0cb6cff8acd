"""The port's ResNets (``bigdl_tpu_torch.models.resnet``) against the
JAX package's, on the CPU, with weights and BatchNorm buffers carried
across by ``load_jax_parameters`` and ``load_jax_buffers``:
``Bottleneck`` on its plain and its fused path (the reference's fused
path run with ``fused="force"``, its Pallas kernels in interpret mode;
the port's with the kernels' plain versions); the strided block; eval
mode and the fused-path selector; and the Optimizer's write-back of
BatchNorm statistics under bf16 compute.  The whole networks are held
in ``test_torch_resnet_models.py``.

Tolerances: layers and blocks float32 rtol 1e-4, atol 1e-5 on outputs
and running statistics (the reference suite's,
``tests/test_fused_conv_bn.py:146-157``); gradients 5e-4 of each
tensor's largest entry (:179), 1e-3 through the deeper networks, whose
sums run in another order through every layer.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import combine, partition
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.interop import (flatten_jax_parameters,
                                     load_jax_buffers, load_jax_parameters)
from bigdl_tpu_torch.models import resnet as presnet
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

OUT = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 5e-4
GEN = dict(generator=torch.Generator().manual_seed(0), device="cpu")


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _carry(ref, port):
    """The reference module's parameters and buffers into the port's."""
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    buffers = jax.tree_util.tree_map(np.asarray, ref.buffers())
    if buffers:
        load_jax_buffers(port, buffers)
    return port


def _run_both(ref, port, x, seed=99):
    """One train-mode forward and backward of loss = sum(out * R), R a
    fixed random cotangent, through both: the reference jitted, returning
    its updated buffers as the Optimizer does.  Returns {"out", "grads",
    "dx", "buffers"} for each, named as the port names them."""
    params, rest = partition(ref.train_mode())
    port.train()
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    r = rnd(*out.shape, seed=seed)
    (out * torch.tensor(r)).sum().backward()

    def loss(p, xj):
        m = combine(p, rest)
        y = m(xj)
        return jnp.sum(y * r), (y, m)

    (_, (y, m)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    as_np = lambda tree: flatten_jax_parameters(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    want = {"out": np.asarray(y), "grads": as_np(gp.parameters()),
            "dx": np.asarray(gx), "buffers": as_np(m.buffers())}
    got = {"out": out.detach().numpy(),
           "grads": {n: p.grad.numpy() for n, p in port.named_parameters()},
           "dx": xt.grad.numpy(),
           "buffers": {n: b.numpy() for n, b in port.named_buffers()}}
    return want, got


def _assert_run(want, got, out=OUT, rel=GRAD_REL):
    np.testing.assert_allclose(got["out"], want["out"], **out)
    _assert_grads(want["grads"], got["grads"], rel)
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=0,
                               atol=rel * np.abs(want["dx"]).max())
    assert set(want["buffers"]) == set(got["buffers"])
    for name in want["buffers"]:
        np.testing.assert_allclose(got["buffers"][name],
                                   want["buffers"][name], **OUT,
                                   err_msg=name)


def _assert_grads(want, got, rel=GRAD_REL):
    assert set(want) == set(got)
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-12)
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=rel * scale, err_msg=name)


# ---- blocks -----------------------------------------------------------------

def _bottlenecks(stride=1, fused_port=False):
    """(reference plain, reference fused "force", port) with equal
    weights."""
    set_seed(7)
    plain = jresnet.Bottleneck(32, 8, stride=stride)
    set_seed(7)
    fused = jresnet.Bottleneck(32, 8, stride=stride, fused="force")
    port = _carry(plain, presnet.Bottleneck(32, 8, stride=stride,
                                            fused=fused_port, **GEN))
    return plain, fused, port


@pytest.mark.parametrize("fused_port", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_matches_reference(stride, fused_port):
    """The port's block on its plain or fused path against the
    reference's fused block (Pallas in interpret mode): output, updated
    running statistics, parameter and input gradients."""
    _, ref, port = _bottlenecks(stride, fused_port)
    _assert_run(*_run_both(ref, port, rnd(4, 8, 8, 32, seed=11)))


def test_eval_mode_ignores_fused():
    plain, _, port = _bottlenecks(fused_port=True)
    port.eval()
    assert port._fused_selection() is None
    x = rnd(2, 8, 8, 32, seed=15)
    np.testing.assert_allclose(
        port(torch.tensor(x)).detach().numpy(),
        np.asarray(plain.eval_mode()(jnp.asarray(x))), **OUT)


def test_fused_selector_follows_the_environment(monkeypatch):
    _, _, port = _bottlenecks(fused_port=False)
    port.train()
    assert port._fused_selection() is None            # off by default
    for env, want in (("1", {"conv1", "conv2", "conv3"}), ("0", None),
                      ("conv3", {"conv3"}),
                      ("conv1, conv2", {"conv1", "conv2"}),
                      ("force", {"conv1", "conv2", "conv3"}),
                      ("conv2,force", {"conv2"})):
        monkeypatch.setenv(presnet.FUSED_ENV, env)
        assert port._fused_selection() == want, env
    monkeypatch.setenv(presnet.FUSED_ENV, "conv4")
    with pytest.raises(ValueError, match="unknown selector"):
        port._fused_selection()
    monkeypatch.setenv(presnet.FUSED_ENV, "0")
    port.fused = "force"                        # accepted as True
    assert port._fused_selection() is None
    monkeypatch.delenv(presnet.FUSED_ENV)
    assert port._fused_selection() == {"conv1", "conv2", "conv3"}
    port.bn1.data_format = "NCHW"               # non-NHWC: plain path
    assert port._fused_selection() is None


def test_selected_convs_take_the_fused_ops(monkeypatch):
    """Only the selected convs go through the fused ops, and the output
    is the plain path's either way."""
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    calls = []
    for name in ("fused_matmul_bn", "fused_conv3x3_bn"):
        real = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    x = torch.tensor(rnd(2, 8, 8, 32, seed=16))
    want = _bottlenecks()[2].train()(x)
    for env, expected in (("conv2", ["fused_conv3x3_bn"]),
                          ("conv1,conv3", ["fused_matmul_bn"] * 2)):
        monkeypatch.setenv(presnet.FUSED_ENV, env)
        calls.clear()
        got = _bottlenecks()[2].train()(x)
        assert calls == expected
        torch.testing.assert_close(got, want, **OUT)
    # a strided conv2 stays plain
    monkeypatch.setenv(presnet.FUSED_ENV, "1")
    calls.clear()
    _bottlenecks(stride=2)[2].train()(x)
    assert calls == ["fused_matmul_bn"] * 2


# ---- the Optimizer's write-back of BatchNorm statistics ---------------------

@pytest.mark.parametrize("steps", [1, 2, 3])
def test_bf16_optimizer_writes_running_stats_back_like_reference(steps):
    """Under bf16 compute the BatchNorm statistics a forward assigns reach
    the model's float32 buffers after every step, and match the
    reference Optimizer's, which casts its updated buffers back to
    float32.  Both steps compute in bf16, so the statistics of bf16
    activations agree to 2e-2."""
    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(8, 8, 8, 3)).astype(np.float32) + 1.0,
                rng.integers(1, 6, (8,)).astype(np.int32))
               for _ in range(3)]
    set_seed(5)
    ref = jresnet.ResNet(jresnet.BasicBlock, [1], class_num=5, cifar=True)
    port = _carry(ref, presnet.ResNet(presnet.BasicBlock, [1], class_num=5,
                                      cifar=True, **GEN))
    ref_opt = JOptimizer(ref, JDataSet.array(
        [JMiniBatch(x, y) for x, y in batches], shuffle=False),
        jnn.CrossEntropyCriterion())
    port_opt = Optimizer(port, DataSet.array(
        [MiniBatch(x, y) for x, y in batches], shuffle=False),
        CrossEntropyCriterion())
    for opt, sgd, trig, dtype in ((ref_opt, JSGD, JTrigger, jnp.bfloat16),
                                  (port_opt, SGD, Trigger, torch.bfloat16)):
        opt.set_optim_method(sgd(0.1, momentum=0.9, dampening=0.0)) \
            .set_end_when(trig.max_iteration(steps)) \
            .set_compute_dtype(dtype)
    want = flatten_jax_parameters(jax.tree_util.tree_map(
        np.asarray, ref_opt.optimize().buffers()))
    port_opt.optimize()
    moved = 0
    for name, buf in port.named_buffers():
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), want[name], rtol=2e-2,
                                   atol=2e-2, err_msg=name)
        start = 0.0 if name.endswith("running_mean") else 1.0
        moved += int(np.abs(want[name] - start).max() > 0.05)
    assert moved >= 4          # the statistics really moved
