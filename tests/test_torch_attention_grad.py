"""The port's attention backward (bigdl_tpu_torch.ops.attention_kernels)
against the JAX package's gradients, on the same numpy inputs:

* the plain versions of the three backward kernels (Δ prep, dQ, dK/dV,
  dBias from the forward's lse) and the autograd Function that runs
  them on CPU tensors, against ``jax.grad`` of the Pallas flash kernel
  (interpret mode, as tests/test_attention.py runs it) and of
  ``xla_attention``;
* dBias folded back to the bias's broadcast shape;
* ragged causal shapes (tq < tk, and tq > tk with rows that see no
  key), which Pallas refuses, against ``xla_attention``'s gradients;
* bf16 gradients.

Tolerances: f32 rtol 2e-3, atol 2e-4, as tests/test_attention.py holds
the Pallas gradients to the XLA ones.  bf16: 3e-2 of the largest
reference entry, rtol 3e-2 -- P and dS are rounded to bf16 at other
points in the two frameworks (the port at the Pallas kernel's points,
XLA's autodiff at its own), a few bf16 ulps in sums of up to 64 terms.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them to these plain versions there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.ops.attention_kernels import flash_attention as jax_flash
from bigdl_tpu.ops.attention_kernels import xla_attention
from bigdl_tpu_torch.ops import attention_kernels as ak

TOL = dict(rtol=2e-3, atol=2e-4)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def jax_grads(fn, q, k, v, bias, w):
    """jax.grad of sum(fn(q, k, v, bias) * w) over q, k, v (and bias)."""
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    g = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias))
    return [np.asarray(x) for x in g]


def plain_grads(q, k, v, bias, w, causal):
    """The plain versions chained as the Function's backward chains the
    kernels: forward with lse, Δ, dQ, dK/dV and the folded dBias."""
    b, h, tq, d = q.shape
    cfg = dict(scale=d ** -0.5, causal=causal,
               causal_offset=k.shape[2] - tq)
    tb = None if bias is None else t(bias)
    out, lse = ak.plain_attention_fwd(t(q), t(k), t(v), tb, **cfg)
    do = t(w)
    delta = ak.attention_delta(out, do)
    args = (t(q), t(k), t(v), tb, do, lse, delta)
    dq = ak.plain_attention_dq(*args, **cfg)
    dk, dv = ak.plain_attention_dkv(*args, **cfg)
    grads = [dq, dk, dv]
    if bias is not None:
        grads.append(ak.fold_bias_grad(ak.plain_attention_dbias(*args, **cfg),
                                       tb, b, h))
    return [g.numpy() for g in grads]


def function_grads(q, k, v, bias, w, causal, dtype=torch.float32):
    """Autograd through the Function on CPU tensors (plain versions)."""
    ins = [t(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else t(bias, grad=True)
    out = ak.flash_attention_with_grad(
        *ins, tb, scale=q.shape[-1] ** -0.5, causal=causal,
        causal_offset=k.shape[2] - q.shape[2])
    (out.float() * t(w)).sum().backward()
    grads = [x.grad.float().numpy() for x in ins]
    if bias is not None:
        grads.append(tb.grad.numpy())
    return grads


def assert_grads(got, want, tol=TOL, label=""):
    assert len(got) == len(want)
    for a, b, name in zip(got, want, "qkvb"):
        assert a.shape == b.shape, (label, name)
        np.testing.assert_allclose(a, b, **tol,
                                   err_msg=f"{label} grad d{name}")


@pytest.mark.parametrize("causal,with_bias", [
    (False, False), (True, False), (False, True), (True, True)])
def test_plain_backward_and_function_match_jax(causal, with_bias):
    q, k, v = (rnd(2, 2, 256, 32, seed=s) for s in (20, 21, 22))
    bias = rnd(2, 1, 256, 256, seed=23) if with_bias else None
    w = rnd(2, 2, 256, 32, seed=24)
    want_flash = jax_grads(
        lambda *a: jax_flash(*a, causal=causal, interpret=True),
        q, k, v, bias, w)
    want_xla = jax_grads(lambda *a: xla_attention(*a, causal=causal),
                         q, k, v, bias, w)
    for label, got in (("plain", plain_grads(q, k, v, bias, w, causal)),
                       ("function", function_grads(q, k, v, bias, w,
                                                   causal))):
        assert_grads(got, want_flash, label=label + " vs pallas")
        assert_grads(got, want_xla, label=label + " vs xla")


@pytest.mark.parametrize("bias_shape", [
    (1, 1, 128, 128), (2, 1, 128, 128), (128, 128), (1, 128, 128)])
def test_dbias_folds_to_the_bias_shape(bias_shape):
    q, k, v = (rnd(2, 3, 128, 16, seed=s) for s in (30, 31, 32))
    bias = rnd(*bias_shape, seed=33)
    w = rnd(2, 3, 128, 16, seed=34)
    want = jax_grads(lambda *a: jax_flash(*a, interpret=True),
                     q, k, v, bias, w)[3]
    got_plain = plain_grads(q, k, v, bias, w, False)[3]
    got_fn = function_grads(q, k, v, bias, w, False)[3]
    for got in (got_plain, got_fn):
        assert got.shape == bias_shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tq,tk", [(40, 100), (100, 40)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_ragged_causal_grads_match_xla(tq, tk, with_bias):
    """End-aligned causal (offset tk - tq).  With tq > tk the first
    tq - tk rows see no key: their forward is uniform over the keys, so
    dV takes 1/Tk of their dO, while dQ, dK and dBias take dS = 0 (the
    gradient of a replaced score)."""
    q = rnd(2, 2, tq, 16, seed=40)
    k, v = rnd(2, 2, tk, 16, seed=41), rnd(2, 2, tk, 16, seed=42)
    bias = rnd(2, 1, tq, tk, seed=43) if with_bias else None
    w = rnd(2, 2, tq, 16, seed=44)
    want = jax_grads(lambda *a: xla_attention(*a, causal=True),
                     q, k, v, bias, w)
    assert_grads(plain_grads(q, k, v, bias, w, True), want, label="plain")
    got = function_grads(q, k, v, bias, w, True)
    assert_grads(got, want, label="function")
    if tq > tk:
        blind = tq - tk
        assert not got[0][:, :, :blind].any()          # dQ of blind rows
        if with_bias:
            assert not got[3][:, :, :blind].any()      # their dBias


def test_fully_bias_masked_row_follows_the_pallas_rounding():
    """Row 5 is masked on every key by an additive -1e9 (an all-padding
    row).  The forward is uniform over the keys there, but lse =
    -1e9 + log(Tk) rounds to -1e9 in f32, so the recomputed P is 1, not
    1/Tk.  The port keeps the Pallas kernel's rounding: its gradients
    equal the Pallas ones everywhere; xla_attention's differ on that row
    (dQ by the factor Tk) and, through it, in dK and dV."""
    q, k, v = (rnd(1, 2, 128, 16, seed=s) for s in (90, 91, 92))
    bias = rnd(1, 1, 128, 128, seed=93)
    bias[:, :, 5] = -1e9
    w = rnd(1, 2, 128, 16, seed=94)
    want_flash = jax_grads(lambda *a: jax_flash(*a, interpret=True),
                           q, k, v, bias, w)
    want_xla = jax_grads(xla_attention, q, k, v, bias, w)
    rows = np.arange(128) != 5
    for label, got in (("plain", plain_grads(q, k, v, bias, w, False)),
                       ("function", function_grads(q, k, v, bias, w,
                                                   False))):
        assert_grads(got, want_flash, label=label + " vs pallas")
        np.testing.assert_allclose(got[0][:, :, rows],
                                   want_xla[0][:, :, rows], **TOL)
        np.testing.assert_allclose(got[0][:, :, 5], 128 * want_xla[0][:, :, 5],
                                   **TOL)


def test_bf16_grads():
    q, k, v = (rnd(2, 2, 64, 32, seed=s) for s in (50, 51, 52))
    w = rnd(2, 2, 64, 32, seed=53)
    bf = jnp.bfloat16
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(
            xla_attention(q_, k_, v_, causal=True).astype(jnp.float32) * w),
        (0, 1, 2))(*(jnp.asarray(x, bf) for x in (q, k, v)))
    got = function_grads(q, k, v, None, w, True, dtype=torch.bfloat16)
    for a, b, name in zip(got, want, "qkv"):
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a, b, rtol=3e-2,
                                   atol=3e-2 * np.abs(b).max(),
                                   err_msg=f"bf16 grad d{name}")


def test_function_runs_dbias_only_when_the_bias_needs_a_gradient(
        monkeypatch):
    calls = []
    fwd, dq, dkv, dbias = ak._PLAIN

    def counted(*a, **kw):
        calls.append(1)
        return dbias(*a, **kw)
    monkeypatch.setattr(ak, "_PLAIN", (fwd, dq, dkv, counted))
    q, k, v = (t(rnd(1, 2, 32, 8, seed=s), grad=True) for s in (60, 61, 62))
    const = t(rnd(1, 1, 32, 32, seed=63))
    out = ak.flash_attention_with_grad(q, k, v, const, scale=8 ** -0.5)
    out.sum().backward()
    assert not calls and const.grad is None and q.grad is not None
    learn = t(rnd(1, 1, 32, 32, seed=63), grad=True)
    ak.flash_attention_with_grad(q, k, v, learn, scale=8 ** -0.5) \
        .sum().backward()
    assert calls == [1] and learn.grad.shape == (1, 1, 32, 32)


def test_cpu_dispatch_is_plain_attention_under_autograd():
    """On CPU tensors dot_product_attention stays plain_attention, which
    autograd differentiates; its grads equal the Function's."""
    q, k, v = (rnd(2, 2, 24, 8, seed=s) for s in (70, 71, 72))
    w = rnd(2, 2, 24, 8, seed=73)
    ins = [t(x, grad=True) for x in (q, k, v)]
    (ak.dot_product_attention(*ins, causal=True) * t(w)).sum().backward()
    assert_grads([x.grad.numpy() for x in ins],
                 function_grads(q, k, v, None, w, True),
                 tol=dict(rtol=1e-4, atol=1e-6))


def test_backward_wrappers_refuse_cpu_tensors():
    q = t(rnd(1, 1, 16, 8, seed=80))
    lse = torch.zeros(1, 16)
    for fn in (ak.flash_attention_dq, ak.flash_attention_dkv,
               ak.flash_attention_dbias):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, q, q, None, q, lse, lse, scale=1.0)
        assert fn.launches == before
