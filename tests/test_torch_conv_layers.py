"""The port's conv, pooling and BatchNorm layers and init methods
(``bigdl_tpu_torch.nn``, ``bigdl_tpu_torch.core.init``) against the JAX
package's, on the CPU, with weights and buffers carried across by
``load_jax_parameters`` and ``load_jax_buffers``.

Tolerances: float32 rtol 1e-4, atol 1e-5 on outputs and running
statistics (the reference suite's, ``tests/test_fused_conv_bn.py:146-157``);
gradients 5e-4 of each tensor's largest entry (:179); max pooling
exactly (both take the first maximum of each window).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.core import init as jinit
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.core import init as port_init
from bigdl_tpu_torch.interop import load_jax_buffers, load_jax_parameters
from bigdl_tpu_torch.nn import (BatchNormalization, SpatialBatchNormalization,
                                SpatialConvolution, SpatialMaxPooling)

from test_torch_resnet import OUT, GRAD_REL, GEN, rnd, _run_both, _assert_run


@pytest.mark.parametrize("cfg", [
    dict(k=3, stride=1, pad=1, groups=1, bias=True, fmt="NHWC"),
    dict(k=3, stride=2, pad=-1, groups=1, bias=False, fmt="NHWC"),
    dict(k=7, stride=2, pad=3, groups=1, bias=False, fmt="NHWC"),
    dict(k=2, stride=2, pad=-1, groups=2, bias=True, fmt="NHWC"),
    dict(k=3, stride=1, pad=0, groups=1, bias=True, fmt="NCHW"),
])
def test_spatial_convolution_matches_reference(cfg):
    k, s, p, g = cfg["k"], cfg["stride"], cfg["pad"], cfg["groups"]
    set_seed(1)
    ref = jnn.SpatialConvolution(4, 6, k, k, s, s, p, p, g,
                                 with_bias=cfg["bias"],
                                 data_format=cfg["fmt"])
    port = SpatialConvolution(4, 6, k, k, s, s, p, p, g,
                              with_bias=cfg["bias"], data_format=cfg["fmt"],
                              **GEN)
    assert tuple(port.weight.shape) == (k, k, 4 // g, 6)     # HWIO
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    shape = (2, 9, 11, 4) if cfg["fmt"] == "NHWC" else (2, 4, 9, 11)
    _assert_run(*_run_both(ref, port, rnd(*shape, seed=2)))


@pytest.mark.parametrize("args,ceil", [
    ((3, 3, 2, 2, 1, 1), False), ((3, 3, 2, 2, 0, 0), True),
    ((2, 2, 2, 2, -1, -1), False), ((3, 2, 1, 2, 1, 0), False)])
def test_max_pooling_matches_reference(args, ceil):
    ref = jnn.SpatialMaxPooling(*args)
    port = SpatialMaxPooling(*args)
    if ceil:
        ref.ceil()
        port.ceil()
    x = rnd(2, 9, 10, 3, seed=3)
    want = ref(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    dy = rnd(*want.shape, seed=4)
    gx = jax.grad(lambda a: jnp.sum(ref(a) * dy))(jnp.asarray(x))
    (got * torch.tensor(dy)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))


@pytest.mark.parametrize("spatial", [False, True])
def test_batch_normalization_matches_reference(spatial):
    """Three train-mode steps (the running statistics compound), eval
    mode, and gradients."""
    set_seed(2)
    if spatial:
        ref, shape = jnn.SpatialBatchNormalization(5), (3, 4, 6, 5)
        port = SpatialBatchNormalization(5, **GEN)
    else:
        ref, shape = jnn.BatchNormalization(5), (12, 5)
        port = BatchNormalization(5, **GEN)
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    load_jax_buffers(port, jax.tree_util.tree_map(np.asarray,
                                                  ref.buffers()))
    for step in range(3):
        x = rnd(*shape, seed=10 + step, scale=2.0) + 3.0
        want = ref.train_mode()(jnp.asarray(x))
        got = port.train()(torch.tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **OUT)
        for name, buf in port.named_buffers():
            np.testing.assert_allclose(buf.numpy(), np.asarray(
                ref.buffers()[name]), **OUT, err_msg=name)
    x = rnd(*shape, seed=20)
    np.testing.assert_allclose(
        port.eval()(torch.tensor(x)).detach().numpy(),
        np.asarray(ref.eval_mode()(jnp.asarray(x))), **OUT)
    _assert_run(*_run_both(ref, port, rnd(*shape, seed=21) + 1.0))


def test_init_methods_follow_the_reference_distributions():
    for shape in ((5,), (4, 3), (3, 3, 64, 128), (2, 4, 3, 3)):
        assert port_init.calc_fans(shape) == jinit.calc_fans(shape)
    g = torch.Generator().manual_seed(0)
    w = port_init.MsraFiller(False)((3, 3, 64, 128), generator=g,
                                    fan_in=576, fan_out=1152)
    assert abs(float(w.std()) - (2.0 / 1152) ** 0.5) < 2e-3
    n = port_init.RandomNormal(0.5, 0.01)((100, 1000), generator=g)
    assert abs(float(n.mean()) - 0.5) < 1e-3 and \
        abs(float(n.std()) - 0.01) < 1e-4
    u = port_init.RandomUniform()((256, 64), generator=g)
    assert 0.12 < float(u.abs().max()) <= 1 / 8
    assert float(port_init.RandomUniform(2.0, 3.0)((100,), generator=g)
                 .min()) >= 2.0
    with pytest.raises(ValueError, match="both bounds"):
        port_init.RandomUniform(0.0)
    with pytest.raises(ValueError, match="generator"):
        BatchNormalization(4, device="cpu")
