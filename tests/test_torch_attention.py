"""The port's attention (bigdl_tpu_torch.ops.attention_kernels) against
the JAX package's: ``plain_attention`` and the CPU dispatch of
``dot_product_attention`` are held to the Pallas flash kernel (run in
interpret mode, as tests/test_attention.py runs it) and to
``xla_attention``, on the same numpy inputs.

Tolerance: rtol 1e-4, atol 1e-5 in float32 -- the two frameworks sum the
products in another order; nothing else differs.  bfloat16 inputs are
held at 2e-2, the rounding of one bf16 ulp near 1.

The CUDA kernel itself has no interpret mode: tests/test_torch_cuda.py
holds it to ``plain_attention`` on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.ops.attention_kernels import flash_attention as jax_flash
from bigdl_tpu.ops.attention_kernels import xla_attention
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.ops import build

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jx(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("causal,with_bias", [
    (False, False), (True, False), (False, True), (True, True)])
def test_port_matches_pallas_flash_and_xla(T, causal, with_bias):
    q, k, v = (rnd(2, 2, T, 32, seed=s) for s in (1, 2, 3))
    bias = rnd(2, 1, T, T, seed=4) if with_bias else None
    want_flash = np.asarray(jax_flash(jx(q), jx(k), jx(v), jx(bias),
                                      causal=causal, interpret=True))
    want_xla = np.asarray(xla_attention(jx(q), jx(k), jx(v), jx(bias),
                                        causal=causal))
    tb = None if bias is None else t(bias)
    plain = ak.plain_attention(t(q), t(k), t(v), tb, causal=causal).numpy()
    dispatched = ak.dot_product_attention(t(q), t(k), t(v), tb,
                                          causal=causal).numpy()
    for got in (plain, dispatched):
        np.testing.assert_allclose(got, want_flash, **TOL)
        np.testing.assert_allclose(got, want_xla, **TOL)


@pytest.mark.parametrize("tq,tk,d", [(100, 300, 32), (1, 64, 16),
                                     (37, 37, 8)])
def test_causal_ragged_is_end_aligned_like_xla(tq, tk, d):
    q, k, v = rnd(2, 3, tq, d, seed=5), rnd(2, 3, tk, d, seed=6), \
        rnd(2, 3, tk, d, seed=7)
    want = np.asarray(xla_attention(jx(q), jx(k), jx(v), causal=True))
    got = ak.dot_product_attention(t(q), t(k), t(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fully_masked_row_is_uniform_over_real_keys():
    """A query row whose every key sits at -1e9 averages V uniformly, as
    xla_attention makes it (the kernel must give the same)."""
    q, k, v = rnd(1, 2, 8, 16, seed=8), rnd(1, 2, 12, 16, seed=9), \
        rnd(1, 2, 12, 16, seed=10)
    bias = np.zeros((1, 1, 8, 12), np.float32)
    bias[..., 3, :] = -1e9
    want = np.asarray(xla_attention(jx(q), jx(k), jx(v), jx(bias)))
    got = ak.dot_product_attention(t(q), t(k), t(v), t(bias)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0, :, 3], v[0].mean(axis=1), **TOL)


def test_bf16_casts_weights_to_v_dtype_like_xla():
    q, k, v = (rnd(2, 2, 64, 32, seed=s) for s in (11, 12, 13))
    bias = rnd(2, 1, 64, 64, seed=14)
    want = np.asarray(xla_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jx(bias)).astype(jnp.float32))
    bf = torch.bfloat16
    got = ak.plain_attention(t(q).to(bf), t(k).to(bf), t(v).to(bf),
                             t(bias))
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_force_flash_on_cpu_raises_and_does_not_fall_back():
    q = t(rnd(1, 1, 128, 16, seed=15))
    before = ak.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.dot_product_attention(q, q, q, force="flash")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.flash_attention_fwd(q, q, q, scale=0.25)
    with pytest.raises(ValueError, match="force must be"):
        ak.dot_product_attention(q, q, q, force="xla")
    assert ak.flash_attention_fwd.launches == before


def test_flash_attention_keeps_start_aligned_causal_contract():
    q, k = t(rnd(1, 1, 4, 8, seed=16)), t(rnd(1, 1, 6, 8, seed=17))
    with pytest.raises(ValueError, match="tq == tk"):
        ak.flash_attention(q, k, k, causal=True)


def test_force_plain_equals_the_cpu_dispatch():
    q, k, v = (t(rnd(2, 2, 16, 8, seed=s)) for s in (18, 19, 20))
    torch.testing.assert_close(
        ak.dot_product_attention(q, k, v, causal=True, force="plain"),
        ak.dot_product_attention(q, k, v, causal=True), rtol=0, atol=0)


def test_find_nvcc_order_and_refusal(tmp_path, monkeypatch):
    """PATH first, then $CUDA_HOME/bin, then the default prefix; raises
    when none holds nvcc."""
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "none")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert build.find_nvcc() == str(nvcc)
    monkeypatch.setattr(build.shutil, "which", lambda _name: "/on/path")
    assert build.find_nvcc() == "/on/path"
