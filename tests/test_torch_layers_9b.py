"""The port's second layer tranche against the JAX package's, on the CPU:
the rest of ``nn/normalization.py`` (and the ``CMul``/``CAdd`` that
``Scale`` is made of), ``nn/regularization.py``, the rest of
``core/init.py``, the conv layer's ``init_weight``/``init_bias`` and
``VolumetricConvolution``.  Deterministic layers are held forward and
backward (the input's gradient and every parameter's, eager
``jax.vjp``), parameters and buffers carried across by name
(``test_torch_rnn.run_both``).

Restates ``tests/test_layers_torch_oracle.py`` :259 (the cross-map LRN
against ``torch.nn.LocalResponseNorm``, rtol 1e-3, atol 1e-4 as there)
and :472 (the same in the sweep, rtol 1e-4, atol 1e-5 as there), and
``tests/test_oracle_sweep_extended.py`` :388 (``Scale``), :449 (the
penalty layers' losses), :678 (``NormalizeScale``'s formula), :685 (the
within-channel LRN against a torch composition, rtol 1e-4, atol 1e-5 as
there) and :700 (``GaussianSampler``).

Tolerance against the reference: float32 rtol 1e-5, atol 1e-6 on
outputs and gradients, loosened to atol 1e-5 for the subtractive,
divisive and contrastive normalizations, whose gradients sum over every
channel of a 9 x 9 window through a convolution in each framework, and
for ``VolumetricConvolution``, whose weight gradient sums some 200
products of entries near 10 (measured 4.5e-6 apart).
Stochastic layers cannot match JAX's masks across RNGs: they are held by
their keep rate (within 4 standard errors), the 1 / (1 - p) scaling
and the zeros where the mask is off, by their arithmetic against the
same draw from a twin generator, and by their determinism under one
generator.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu.core import init as jinit
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core import init as pinit
from bigdl_tpu_torch.core.module import dropout, forward_context

from test_torch_rnn import (OUT, assert_run, carry, gen,  # noqa: F401
                            one_torch_thread, rnd, run_both)

LOCAL = dict(rtol=1e-5, atol=1e-5)


def pos(*shape, seed=0):
    return np.abs(rnd(*shape, seed=seed)) + 0.1


def hold(ref, port, inputs, tol=OUT, **kw):
    assert_run(*run_both(ref, carry(ref, port), inputs, **kw), out=tol,
               grad=tol)


# ---- nn/normalization.py, the rest -------------------------------------------

NORMS = [
    ("Normalize2", lambda m, k: m.Normalize(2.0), lambda: [rnd(4, 5)], OUT),
    ("Normalize3", lambda m, k: m.Normalize(3.0), lambda: [rnd(4, 5)], OUT),
    ("NormalizeInf", lambda m, k: m.Normalize(float("inf")),
     lambda: [rnd(4, 5)], OUT),
    ("NormalizeScale", lambda m, k: m.NormalizeScale(2.0, scale=3.0,
                                                     size=(5,), **k),
     lambda: [rnd(2, 3, 5)], OUT),
    ("NormalizeScale1", lambda m, k: m.NormalizeScale(2.0, scale=2.0, **k),
     lambda: [rnd(4, 5)], OUT),
    ("CrossMapLRN", lambda m, k: m.SpatialCrossMapLRN(5, 1.0, 0.75, 1.0),
     lambda: [pos(2, 6, 6, 7)], OUT),
    ("CrossMapLRN_inception", lambda m, k: m.SpatialCrossMapLRN(
        5, 0.0001, 0.75), lambda: [rnd(2, 4, 4, 9) * 3], OUT),
    ("CrossMapLRN_nchw", lambda m, k: m.SpatialCrossMapLRN(
        4, 0.5, 0.6, 2.0, data_format="NCHW"),
     lambda: [rnd(2, 6, 5, 5)], OUT),
    ("WithinChannelLRN", lambda m, k: m.SpatialWithinChannelLRN(3, 1.0, 0.75),
     lambda: [rnd(2, 6, 6, 4)], OUT),
    ("WithinChannelLRN4", lambda m, k: m.SpatialWithinChannelLRN(4, 0.5, 0.7),
     lambda: [rnd(2, 5, 7, 3)], OUT),
    ("Scale", lambda m, k: m.Scale((4,), **k), lambda: [rnd(3, 4)], OUT),
    ("Scale2d", lambda m, k: m.Scale((3, 4), **k), lambda: [rnd(2, 3, 4)],
     OUT),
    ("CMul", lambda m, k: m.CMul((1, 4), **k), lambda: [rnd(3, 4)], OUT),
    ("CAdd", lambda m, k: m.CAdd((4,), **k), lambda: [rnd(3, 4)], OUT),
    ("Subtractive", lambda m, k: m.SpatialSubtractiveNormalization(3, **k),
     lambda: [rnd(2, 10, 10, 3)], LOCAL),
    ("Subtractive_1d", lambda m, k: m.SpatialSubtractiveNormalization(
        3, np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32), **k),
     lambda: [rnd(2, 7, 8, 3)], LOCAL),
    ("Subtractive_even", lambda m, k: m.SpatialSubtractiveNormalization(
        2, np.ones((3, 4), np.float32), **k), lambda: [rnd(1, 6, 7, 2)],
     LOCAL),
    ("Divisive", lambda m, k: m.SpatialDivisiveNormalization(
        3, np.ones(5, np.float32), **k), lambda: [rnd(2, 8, 8, 3)], LOCAL),
    ("Divisive_threshold", lambda m, k: m.SpatialDivisiveNormalization(
        3, np.ones(3, np.float32), 1.2, 0.8, **k),
     lambda: [rnd(2, 6, 6, 3)], LOCAL),
    ("Contrastive", lambda m, k: m.SpatialContrastiveNormalization(
        3, np.ones(5, np.float32), **k), lambda: [rnd(2, 8, 8, 3)], LOCAL),
    ("GroupNorm", lambda m, k: m.GroupNorm(8, 4, **k),
     lambda: [rnd(2, 3, 3, 8)], OUT),
    ("GroupNorm_halved", lambda m, k: m.GroupNorm(6, 4, **k),
     lambda: [rnd(2, 4, 6)], OUT),
    ("GroupNorm_plain", lambda m, k: m.GroupNorm(8, 2, affine=False, **k),
     lambda: [rnd(3, 8)], OUT),
]

_DEVICE_ONLY = ("NormalizeScale", "Subtractive", "Divisive", "Contrastive",
                "GroupNorm")


def _port_kw(name):
    if name.startswith(("Scale", "CMul", "CAdd")):
        return gen()
    if name.startswith(_DEVICE_ONLY):
        return dict(device="cpu")
    return {}


@pytest.mark.parametrize("name,make,inputs,tol", NORMS,
                         ids=[n[0] for n in NORMS])
def test_normalization_matches_reference(name, make, inputs, tol):
    set_seed(sum(map(ord, name)))
    ref = make(jnn, {})
    if name.startswith("GroupNorm") and ref.affine:
        # move the affine parameters off their constant initial values
        ref.load_parameters({
            "weight": ref.weight + jnp.asarray(rnd(*ref.weight.shape,
                                                   seed=9)),
            "bias": ref.bias + jnp.asarray(rnd(*ref.bias.shape, seed=10))})
    hold(ref, make(pnn, _port_kw(name)), inputs(), tol)


def test_normalization_module_exports_every_reference_class():
    from bigdl_tpu.nn import normalization as jn
    from bigdl_tpu_torch.nn import normalization as pn
    assert sorted(pn.__all__) == sorted(jn.__all__)


def test_cross_map_lrn_matches_torch():
    """test_layers_torch_oracle.py:259 and :472: against
    torch.nn.LocalResponseNorm, which pads and divides its own way, at
    those tests' tolerances."""
    m = torch.nn.LocalResponseNorm(5, alpha=1.0, beta=0.75, k=1.0)
    layer = pnn.SpatialCrossMapLRN(size=5, alpha=1.0, beta=0.75, k=1.0)
    for x, tol in ((rnd(2, 5, 5, 8), dict(rtol=1e-3, atol=1e-4)),
                   (pos(2, 6, 6, 7, seed=46), dict(rtol=1e-4, atol=1e-5))):
        x = torch.tensor(x)
        want = m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(layer(x).numpy(), want.numpy(), **tol)


def test_within_channel_lrn_matches_torch_compose():
    """test_oracle_sweep_extended.py:685."""
    x = rnd(2, 6, 6, 4, seed=127)
    tx = torch.tensor(np.transpose(x, (0, 3, 1, 2)))
    local_sum = F.avg_pool2d(tx * tx, 3, stride=1, padding=1,
                             count_include_pad=True) * 9.0
    want = tx * (1.0 + (1.0 / 9.0) * local_sum).pow(-0.75)
    got = pnn.SpatialWithinChannelLRN(size=3, alpha=1.0, beta=0.75)(
        torch.tensor(x))
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-5)


def test_normalize_scale_and_scale_formulas():
    """test_oracle_sweep_extended.py:678 and :388."""
    x = torch.tensor(rnd(4, 5, seed=126))
    layer = pnn.NormalizeScale(p=2.0, scale=3.0, size=(5,), device="cpu")
    n = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-10)
    np.testing.assert_allclose(layer(x).detach().numpy(), (n * 3.0).numpy(),
                               rtol=1e-5)
    s = pnn.Scale((4,), **gen())
    x = torch.tensor(rnd(3, 4, seed=101))
    np.testing.assert_allclose(
        s(x).detach().numpy(),
        (x * s.cmul.weight + s.cadd.bias).detach().numpy(), **OUT)


# ---- nn/regularization.py ----------------------------------------------------

def _train(m, x, seed):
    m.train()
    with forward_context(generator=torch.Generator().manual_seed(seed)):
        return m(x)


STOCHASTIC = [
    ("Dropout", lambda: pnn.Dropout(0.3), (40, 50)),
    ("Dropout_unscaled", lambda: pnn.Dropout(0.3, scale=False), (40, 50)),
    ("SpatialDropout1D", lambda: pnn.SpatialDropout1D(0.4), (200, 3, 10)),
    ("SpatialDropout2D", lambda: pnn.SpatialDropout2D(0.4), (200, 3, 3, 10)),
    ("SpatialDropout2D_nchw", lambda: pnn.SpatialDropout2D(
        0.4, data_format="NCHW"), (200, 10, 3, 3)),
    ("SpatialDropout3D", lambda: pnn.SpatialDropout3D(0.4),
     (200, 2, 2, 2, 10)),
    ("GaussianDropout", lambda: pnn.GaussianDropout(0.2), (40, 50)),
    ("GaussianNoise", lambda: pnn.GaussianNoise(0.5), (40, 50)),
]


@pytest.mark.parametrize("name,make,shape", STOCHASTIC,
                         ids=[s[0] for s in STOCHASTIC])
def test_stochastic_layer_modes_and_determinism(name, make, shape):
    """Eval mode returns the input itself; training draws from the
    generator in scope (one seed twice: equal; two seeds: not) and
    raises without one."""
    m = make()
    x = torch.tensor(pos(*shape, seed=3))
    assert m.eval()(x) is x
    a, b, c = _train(m, x, 1), _train(m, x, 1), _train(m, x, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(RuntimeError, match="No RNG in scope"):
        m.train()(x)


@pytest.mark.parametrize("name,make,shape", STOCHASTIC[:6],
                         ids=[s[0] for s in STOCHASTIC[:6]])
def test_dropout_keep_rate_scale_and_zeros(name, make, shape):
    """The kept share is 1 - p within 4 standard errors over the mask's
    draws; kept entries are x / (1 - p) (Dropout) or x (unscaled and
    spatial: the reference scales neither), the rest exactly 0; a
    spatial mask is one draw per (batch, channel)."""
    m = make()
    x = torch.tensor(pos(*shape, seed=4))
    y = _train(m, x, 5)
    kept = y != 0
    spatial = name.startswith("Spatial")
    if spatial:
        chan = 1 if name.endswith("nchw") else -1
        per = kept.transpose(chan, -1).reshape(shape[0], -1, shape[chan])
        assert torch.all(per == per[:, :1])          # constant over space
        draws = per[:, 0]
    else:
        draws = kept
    share = float(draws.float().mean())
    assert abs(share - (1 - m.p)) < 4 * (m.p * (1 - m.p)
                                         / draws.numel()) ** 0.5
    scale = 1 / (1 - m.p) if name == "Dropout" else 1.0
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] * scale).numpy(),
                               rtol=1e-6)
    assert torch.all(y[~kept] == 0)


def test_dropout_is_the_context_generators_mask():
    """Dropout's arithmetic against the same draw from a twin generator:
    keep = U < 1 - p, kept entries x / (1 - p)."""
    x = torch.tensor(rnd(30, 40, seed=6))
    y = _train(pnn.Dropout(0.25), x, 7)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(7)) \
        < 0.75
    assert torch.equal(y, torch.where(keep, x / 0.75, torch.zeros(())))
    with forward_context(generator=torch.Generator().manual_seed(7)):
        assert torch.equal(y, dropout(x, 0.25))
    assert torch.equal(_train(pnn.Dropout(0.0), x, 7), x)


def test_gaussian_layers_statistics():
    """GaussianDropout multiplies by N(1, rate / (1 - rate)),
    GaussianNoise adds N(0, stddev): moments over 200,000 draws."""
    x = torch.full((400, 500), 2.0)
    r = _train(pnn.GaussianDropout(0.2), x, 8) / x
    assert abs(float(r.mean()) - 1) < 0.005
    assert abs(float(r.std()) - 0.5) < 0.005
    n = _train(pnn.GaussianNoise(0.3), x, 9) - x
    assert abs(float(n.mean())) < 0.003
    assert abs(float(n.std()) - 0.3) < 0.003


def test_gaussian_sampler_reparameterization():
    """test_oracle_sweep_extended.py:700: one generator gives one sample;
    the standardized residual is N(0, 1)-sized; no generator raises, in
    either mode (the reference draws in both)."""
    mean = torch.tensor(rnd(4, 6, seed=128))
    log_var = torch.tensor(rnd(4, 6, seed=129) * 0.2)
    layer = pnn.GaussianSampler()
    z1, z2 = (_train(layer, (mean, log_var), 3) for _ in range(2))
    assert torch.equal(z1, z2)
    eps = (z1 - mean) / torch.exp(0.5 * log_var)
    assert float(eps.abs().max()) < 6.0
    for mode in (True, False):
        with pytest.raises(RuntimeError, match="No RNG in scope"):
            layer.train(mode)((mean, log_var))


def test_penalty_layers_record_loss():
    """test_oracle_sweep_extended.py:449: identity forwards whose
    ``loss`` buffer is the formula, and the reference's (carried through
    ``run_both``'s buffers); the loss is differentiable."""
    x = torch.tensor(rnd(3, 4, seed=106), requires_grad=True)
    l1 = pnn.L1Penalty(0.5, device="cpu")
    assert l1(x) is x
    np.testing.assert_allclose(float(l1.loss.detach()),
                               0.5 * float(x.detach().abs().sum()),
                               rtol=1e-6)
    l1.loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), 0.5 * np.sign(
        x.detach().numpy()), rtol=1e-6)
    ar = pnn.ActivityRegularization(l1=0.3, l2=0.7, device="cpu")
    ar(x)
    d = x.detach()
    np.testing.assert_allclose(
        float(ar.loss.detach()), 0.3 * float(d.abs().sum())
        + 0.7 * float((d * d).sum()), rtol=1e-6)
    p = torch.tensor(pos(3, 4, seed=107))
    p = p / p.sum(-1, keepdim=True)
    ne = pnn.NegativeEntropyPenalty(0.2, device="cpu")
    ne(p)
    np.testing.assert_allclose(float(ne.loss),
                               0.2 * float((p * torch.log(p)).sum()),
                               rtol=1e-5)
    for ref, port, x in (
            (jnn.L1Penalty(0.5, size_average=True),
             pnn.L1Penalty(0.5, size_average=True, device="cpu"),
             rnd(3, 4, seed=108)),
            (jnn.ActivityRegularization(0.3, 0.7),
             pnn.ActivityRegularization(0.3, 0.7, device="cpu"),
             rnd(3, 4, seed=109)),
            (jnn.NegativeEntropyPenalty(0.2),
             pnn.NegativeEntropyPenalty(0.2, device="cpu"),
             pos(3, 4, seed=110))):
        hold(ref, port, [x])


def test_regularization_module_exports_every_reference_class():
    from bigdl_tpu.nn import regularization as jr
    from bigdl_tpu_torch.nn import regularization as pr
    assert sorted(pr.__all__) == sorted(jr.__all__)


# ---- core/init.py, the rest --------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 3, 5), (3, 2, 1, 2)])
def test_bilinear_filler_matches_reference(shape):
    want = np.asarray(jinit.BilinearFiller()(jax.random.key(0), shape))
    for method in (pinit.BilinearFiller(), pinit.Bilinear):
        got = method(shape, generator=torch.Generator())
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="out, in, kh, kw"):
        pinit.Bilinear((3, 3), generator=torch.Generator())


@pytest.mark.parametrize("shape,fans", [((64, 32), None), ((3, 3, 16, 8),
                                                          None),
                                        ((5, 5, 6, 12), (150, 300))])
def test_xavier_bound_shape_and_generator(shape, fans):
    """U(-b, b), b = sqrt(6 / (fan_in + fan_out)): the reference's fans
    (calc_fans, or the caller's), its shape; equal under one generator."""
    kw = {} if fans is None else dict(fan_in=fans[0], fan_out=fans[1])
    fi, fo = fans or jinit.calc_fans(shape)
    assert pinit.calc_fans(shape) == jinit.calc_fans(shape)
    bound = (6.0 / (fi + fo)) ** 0.5
    a = pinit.Xavier(shape, generator=torch.Generator().manual_seed(3), **kw)
    b = pinit.Xavier(shape, generator=torch.Generator().manual_seed(3), **kw)
    ref = np.asarray(jinit.Xavier(jax.random.key(3), shape, **kw))
    assert tuple(a.shape) == ref.shape and torch.equal(a, b)
    assert float(a.abs().max()) <= bound
    assert float(a.abs().max()) > 0.9 * bound
    assert abs(float(a.std()) - bound / 3 ** 0.5) < 0.1 * bound
    assert np.abs(ref).max() <= bound


def test_constant_inits_match_reference():
    shape = (3, 4)
    key = jax.random.key(0)
    for port, ref in ((pinit.Zeros, jinit.Zeros), (pinit.Ones, jinit.Ones),
                      (pinit.ConstInitMethod(0.3),
                       jinit.ConstInitMethod(0.3))):
        got = port(shape, generator=torch.Generator())
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref(key,
                                                                  shape)))
        assert got.dtype == torch.float32


def test_init_module_exports_every_reference_method():
    exported = set(pinit.__all__) - {"InitMethod"}
    assert exported == set(jinit.__all__)


# ---- the conv layers ---------------------------------------------------------

def test_conv_init_weight_and_bias_match_reference():
    """``init_weight``/``init_bias`` are the HWIO weight and the bias as
    given (no generator needed); ``propagate_back=False`` changes
    nothing, as in the reference."""
    w = rnd(3, 3, 2, 4, seed=111)
    b = rnd(4, seed=112)
    ref = jnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, propagate_back=False,
                                 init_weight=jnp.asarray(w),
                                 init_bias=jnp.asarray(b))
    port = pnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, init_weight=w,
                                  init_bias=torch.tensor(b),
                                  propagate_back=False, device="cpu")
    np.testing.assert_array_equal(port.weight.detach().numpy(), w)
    np.testing.assert_array_equal(port.bias.detach().numpy(), b)
    assert_run(*run_both(ref, port, [rnd(2, 5, 5, 2, seed=113)]))
    with pytest.raises(ValueError, match="init_weight has shape"):
        pnn.SpatialConvolution(2, 4, 3, 3, init_weight=w[:2], device="cpu")
    with pytest.raises(ValueError, match="generator"):
        pnn.SpatialConvolution(2, 4, 3, 3, init_weight=w, device="cpu")


def test_conv_xavier_init_method():
    """The Inception convs' init: Xavier with the conv's fans (in /
    groups x kh x kw, out / groups x kh x kw)."""
    conv = pnn.SpatialConvolution(16, 32, 3, 3, 1, 1, 1, 1, 2,
                                  init_method=pinit.Xavier, **gen(4))
    bound = (6.0 / (8 * 9 + 16 * 9)) ** 0.5
    w = conv.weight.detach()
    assert tuple(w.shape) == (3, 3, 8, 32)
    assert bound * 0.9 < float(w.abs().max()) <= bound
    again = pnn.SpatialConvolution(16, 32, 3, 3, 1, 1, 1, 1, 2,
                                   init_method=pinit.Xavier, **gen(4))
    assert torch.equal(w, again.weight.detach())


@pytest.mark.parametrize("args,fmt", [
    ((2, 3, 3, 3, 3), "NDHWC"),
    ((2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1), "NDHWC"),
    ((2, 3, 3, 2, 2, 2, 1, 1, -1, -1, -1), "NDHWC"),
    ((2, 4, 2, 3, 3, 1, 2, 2, 0, 1, 1), "NCDHW"),
])
def test_volumetric_convolution_matches_reference(args, fmt):
    set_seed(12)
    ref = jnn.VolumetricConvolution(*args, data_format=fmt)
    port = pnn.VolumetricConvolution(*args, data_format=fmt, **gen())
    shape = (2, 5, 6, 6, 2) if fmt == "NDHWC" else (2, 2, 5, 6, 6)
    hold(ref, port, [rnd(*shape, seed=114)], LOCAL)
