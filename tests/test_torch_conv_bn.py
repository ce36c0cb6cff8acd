"""The port's fused conv+BN ops (``bigdl_tpu_torch/ops/conv_bn_kernels.py``)
against the JAX package's (``bigdl_tpu/ops/conv_bn_kernels.py``), on the
CPU: the port's autograd Functions run the plain versions of kernels
#8-#11 there, and the reference's Pallas kernels run in interpret mode,
as ``tests/test_fused_conv_bn.py`` runs them.

Tolerances are the reference suite's: float32 values 3e-5
(``tests/test_fused_conv_bn.py:136``), gradients 5e-4 (:179) of the
largest entry (the sums run in another order through a loss of the
statistics).  The statistics are sums over every row, so they are held
to 3e-5 of the sum of |y - K| (s1) and of s2 itself.  bfloat16 outputs
must lie within one bf16 ulp of the reference, and at most 1% of them may
differ at all: a different f32 summation order moves only entries near a
rounding boundary, where a missing cast would move almost half.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.ops import conv_bn_kernels as jk
from bigdl_tpu_torch.ops import conv_bn_kernels as ck

F32 = dict(rtol=3e-5, atol=3e-5)
GRAD_REL = 5e-4


def rnd(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _norm(c, seed):
    return (rnd(c, seed=seed, scale=0.1),
            np.abs(rnd(c, seed=seed + 1)) + 0.5,
            rnd(c, seed=seed + 2, scale=0.2))


def _port(op, x, w, norm, kshift, dtype=torch.float32, grad=False):
    xt = torch.tensor(x).to(dtype).requires_grad_(grad)
    wt = torch.tensor(w).to(dtype).requires_grad_(grad)
    nt = None if norm is None else [torch.tensor(v).requires_grad_(grad)
                                    for v in norm]
    kt = None if kshift is None else torch.tensor(kshift)
    return op(xt, wt, norm=nt, kshift=kt), (xt, wt, nt)


def _ref(op, x, w, norm, kshift, dtype=jnp.float32, **kw):
    n = None if norm is None else tuple(jnp.asarray(v) for v in norm)
    k = None if kshift is None else jnp.asarray(kshift)
    return op(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
              norm=n, kshift=k, interpret=True, **kw)


def _assert_stats(got, want, y, kshift):
    s1, s2 = (t.detach().numpy() for t in got)
    yk = y.detach().float().numpy() - kshift
    mass = np.abs(yk).reshape(-1, yk.shape[-1]).sum(0)
    np.testing.assert_array_less(np.abs(s1 - np.asarray(want[0])),
                                 3e-5 * mass + 1e-6)
    np.testing.assert_array_less(np.abs(s2 - np.asarray(want[1])),
                                 3e-5 * np.asarray(want[1]) + 1e-6)


def _problem(kind, seed):
    if kind == "1x1":
        x, w = rnd(96, 24, seed=seed, scale=1.5, shift=0.3), \
            rnd(24, 40, seed=seed + 1, scale=0.2)
        return x, w, 24, 40, ck.fused_matmul_bn, jk.fused_matmul_bn, {}
    x, w = rnd(2, 8, 6, 4, seed=seed, scale=1.5), \
        rnd(3, 3, 4, 8, seed=seed + 1, scale=0.2)
    return x, w, 4, 8, ck.fused_conv3x3_bn, jk.fused_conv3x3_bn, \
        {"block_h": 4}


@pytest.mark.parametrize("kind", ["1x1", "3x3"])
@pytest.mark.parametrize("with_norm,with_kshift", [
    (False, False), (True, False), (False, True), (True, True)])
def test_values_and_statistics_match_reference(kind, with_norm,
                                               with_kshift):
    x, w, c, co, op, ref_op, kw = _problem(kind, 10)
    norm = _norm(c, 20) if with_norm else None
    kshift = rnd(co, seed=30, scale=0.05) if with_kshift else None
    got, _ = _port(op, x, w, norm, kshift)
    want = _ref(ref_op, x, w, norm, kshift, **kw)
    if not with_kshift:
        got, want = (got,), (want,)
    assert got[0].dtype == torch.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **F32)
    if with_kshift:
        _assert_stats(got[1:], want[1:], got[0], kshift)


def _loss_torch(out):
    y, s1, s2 = out
    return (y.float() ** 2).sum() + torch.sin(s1).sum() \
        + 0.1 * torch.cos(s2).sum()


def _loss_jax(out):
    y, s1, s2 = out
    return (jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(s1))
            + 0.1 * jnp.sum(jnp.cos(s2)))


@pytest.mark.parametrize("kind", ["1x1", "3x3"])
@pytest.mark.parametrize("with_norm", [True, False])
def test_gradients_match_jax_grad_of_the_custom_vjp(kind, with_norm):
    """Gradients through the autograd Function against ``jax.grad`` of
    the reference's ``custom_vjp``, with a loss of y, s1 and s2, so the
    statistics cotangents flow back into the backward kernel."""
    x, w, c, co, op, ref_op, kw = _problem(kind, 40)
    norm = _norm(c, 50) if with_norm else None
    kshift = rnd(co, seed=60, scale=0.05)
    out, (xt, wt, nt) = _port(op, x, w, norm, kshift, grad=True)
    _loss_torch(out).backward()
    got = [xt.grad, wt.grad] + ([v.grad for v in nt] if nt else [])

    def loss(xj, wj, nj):
        n = None if nj is None else tuple(nj)
        return _loss_jax(ref_op(xj, wj, norm=n, kshift=jnp.asarray(kshift),
                                interpret=True, **kw))

    args = (jnp.asarray(x), jnp.asarray(w),
            None if norm is None else tuple(jnp.asarray(v) for v in norm))
    want = jax.tree_util.tree_leaves(
        jax.grad(loss, argnums=(0, 1, 2) if norm else (0, 1))(*args))
    assert len(got) == len(want)
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_REL * np.abs(r).max())


@pytest.mark.parametrize("h,w,block_h", [(3, 7, 1), (6, 5, 2), (9, 4, 3)])
def test_ragged_block_h_shapes_match_reference(h, w, block_h):
    """The reference cuts H into blocks with halo rows; the port's 3x3
    has no blocks: values, statistics and gradients agree on shapes whose
    blocks leave halos everywhere."""
    x = rnd(2, h, w, 4, seed=70, scale=1.5)
    wt = rnd(3, 3, 4, 8, seed=71, scale=0.2)
    norm, kshift = _norm(4, 72), rnd(8, seed=75, scale=0.05)
    out, (xp, wp, nt) = _port(ck.fused_conv3x3_bn, x, wt, norm, kshift,
                              grad=True)
    want = _ref(jk.fused_conv3x3_bn, x, wt, norm, kshift, block_h=block_h)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(want[0]),
                               **F32)
    _assert_stats(out[1:], want[1:], out[0], kshift)
    _loss_torch(out).backward()
    grads = jax.grad(lambda a, b, n: _loss_jax(jk.fused_conv3x3_bn(
        a, b, norm=n, kshift=jnp.asarray(kshift), block_h=block_h,
        interpret=True)), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(wt), tuple(jnp.asarray(v) for v in norm))
    for g, r in zip([xp.grad, wp.grad] + [v.grad for v in nt],
                    jax.tree_util.tree_leaves(grads)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_REL * np.abs(r).max())


def _bf16_close(got, want):
    """Within one bf16 ulp of the reference entry, and at most 1% of the
    entries differing."""
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= 0.01


@pytest.mark.parametrize("kind", ["1x1", "3x3"])
def test_bf16_values_and_gradients_match_reference(kind):
    x, w, c, co, op, ref_op, kw = _problem(kind, 80)
    norm, kshift = _norm(c, 90), rnd(co, seed=95, scale=0.05)
    out, (xt, wt, _) = _port(op, x, w, norm, kshift, torch.bfloat16,
                             grad=True)
    want = _ref(ref_op, x, w, norm, kshift, jnp.bfloat16, **kw)
    assert out[0].dtype == torch.bfloat16
    _bf16_close(out[0], want[0])
    # the statistics of the rounded y, summed from the op's own y
    own = ck.shifted_batch_stats(out[0].detach(), torch.tensor(kshift))
    _assert_stats(out[1:], [t.numpy() for t in own], out[0], kshift)
    (out[0].float() ** 2).sum().backward()
    n = tuple(jnp.asarray(v) for v in norm)
    gx, gw = jax.grad(lambda a, b: jnp.sum(ref_op(
        a, b, norm=n, kshift=jnp.asarray(kshift), interpret=True,
        **kw)[0].astype(jnp.float32) ** 2), argnums=(0, 1))(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(w).astype(jnp.bfloat16))
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    _bf16_close(xt.grad, gx)
    _bf16_close(wt.grad, gw)


def test_plain_kernels_match_the_reference_oracles():
    """Each kernel's plain version against the reference's unfused
    oracle, and the backward's channel sums against autograd of it."""
    x, w = rnd(64, 16, seed=100, scale=1.5), rnd(16, 24, seed=101, scale=0.2)
    norm, kshift = _norm(16, 102), rnd(24, seed=105, scale=0.05)
    t = [torch.tensor(v) for v in (x, w, *norm, kshift)]
    y, s1, s2 = ck.plain_matmul_bn_fwd(*t, fuse_input=True, emit_stats=True)
    want = jk.fused_matmul_bn_reference(jnp.asarray(x), jnp.asarray(w),
                                        tuple(map(jnp.asarray, norm)),
                                        jnp.asarray(kshift))
    for g, r in zip((y, s1, s2), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-5,
                                   atol=1e-4)
    x4, w4 = rnd(2, 5, 6, 16, seed=106, scale=1.5), rnd(3, 3, 16, 24,
                                                        seed=107, scale=0.2)
    t4 = [torch.tensor(v) for v in (x4, w4, *norm, kshift)]
    y4, _, _ = ck.plain_conv3x3_bn_fwd(*t4, fuse_input=True,
                                       emit_stats=True)
    want4 = jk.fused_conv3x3_bn_reference(jnp.asarray(x4), jnp.asarray(w4),
                                          tuple(map(jnp.asarray, norm)),
                                          jnp.asarray(kshift))
    np.testing.assert_allclose(y4.numpy(), np.asarray(want4[0]), **F32)
    # the backward's sums: dscale = dsx - mean * dsu, dbeta = dsu
    dy = torch.tensor(rnd(2, 5, 6, 24, seed=108))
    zeros = torch.zeros(24)
    dx, dw, dsx, dsu = ck.plain_conv3x3_bn_bwd(
        *t4, y4, dy, zeros, zeros, fuse_input=True, emit_stats=False)
    leaves = [v.clone().requires_grad_() for v in t4[:5]]
    ref = ck.fused_conv3x3_bn_reference(leaves[0], leaves[1], leaves[2:5])
    (ref * dy).sum().backward()
    for g, r in ((dx, leaves[0].grad), (dw, leaves[1].grad),
                 (dsu, leaves[4].grad), (dsx - t4[2] * dsu, leaves[3].grad),
                 (-t4[3] * dsu, leaves[2].grad)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_supported_shapes_and_dw_scratch():
    """Every ResNet-50 shape of the fused path is taken, the stage-4 3x3
    included (the TPU's VMEM budget refused it), and the f32 dW partials
    stay within 256 MiB; a dW too large for one partial is refused."""
    b = 128
    for m, k, n in ((b * 56 * 56, 64, 64), (b * 56 * 56, 64, 256),
                    (b * 56 * 56, 256, 64), (b * 28 * 28, 512, 128),
                    (b * 14 * 14, 1024, 256), (b * 7 * 7, 512, 2048),
                    (b * 7 * 7, 2048, 512)):
        assert ck.fused_block_supported(m, k, n)
        assert ck.dw_splits(m, k, n) * k * n * 4 <= 256 * 2 ** 20
    for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512)):
        assert ck.fused_conv3x3_supported(hw, hw, c, c)
        assert ck.dw_splits(b * hw * hw, 9 * c, c) * 9 * c * c * 4 \
            <= 256 * 2 ** 20
    assert ck.dw_splits(b * 56 * 56, 64, 64) > 100      # fills the card
    assert not ck.fused_block_supported(64, 16384, 16384)
    assert not ck.fused_conv3x3_supported(7, 7, 4096, 4096)
    assert not ck.fused_block_supported(64, 64, 64, itemsize=8)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w = torch.zeros(8, 4), torch.zeros(4, 4)
    v = torch.zeros(4)
    for call in (lambda: ck.matmul_bn_fwd(x, w, v, v, v, v, fuse_input=True,
                                          emit_stats=True),
                 lambda: ck.matmul_bn_bwd(x, w, v, v, v, v, x, x, v, v,
                                          fuse_input=True, emit_stats=True),
                 lambda: ck.conv3x3_bn_fwd(
                     torch.zeros(1, 2, 2, 4), torch.zeros(3, 3, 4, 4), v, v,
                     v, v, fuse_input=False, emit_stats=False)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    before = [k.launches for k in ck._KERNELS]
    ck.fused_matmul_bn(x, w, kshift=v)          # CPU: the plain versions
    assert [k.launches for k in ck._KERNELS] == before
    with pytest.raises(ValueError, match="cannot take"):
        ck.fused_matmul_bn(torch.zeros(4, 16384),
                           torch.zeros(1).expand(16384, 16384))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_norm", [True, False])
def test_saved_y_backward_matches_the_fused_core_vjp(dtype, with_norm):
    """The port's 1x1 saves the forward's y and its backward folds the
    statistics cotangents with it; the reference's ``_fused_core`` saves
    (x, w, mean, scale, beta, kshift) and recomputes y.  On the CPU the
    saved y is the plain forward's, so dx, dW and the norm vectors'
    gradients (from dsx and dsu) equal ``jax.vjp`` of the reference at the
    same cotangents (dy, gm, gs), from the same weights."""
    x, w, c, co, op, ref_op, kw = _problem("1x1", 110)
    norm = _norm(c, 120) if with_norm else None
    kshift = rnd(co, seed=125, scale=0.05)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    dy = rnd(x.shape[0], co, seed=126)
    gm, gs = rnd(co, seed=127, scale=0.1), rnd(co, seed=128, scale=0.1)
    out, (xt, wt, nt) = _port(op, x, w, norm, kshift, tdt, grad=True)
    torch.autograd.backward(out, (torch.tensor(dy).to(tdt),
                                  torch.tensor(gm), torch.tensor(gs)))
    got = [xt.grad, wt.grad] + ([v.grad for v in nt] if nt else [])

    def ref(xj, wj, nj):
        return ref_op(xj, wj, norm=nj, kshift=jnp.asarray(kshift),
                      interpret=True)
    primals = (jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
               None if norm is None else tuple(jnp.asarray(v) for v in norm))
    _, vjp = jax.vjp(ref, *primals)
    want = jax.tree_util.tree_leaves(vjp((jnp.asarray(dy).astype(jdt),
                                          jnp.asarray(gm), jnp.asarray(gs))))
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16:
            _bf16_close(g, r)
        else:
            r = np.asarray(r, dtype=np.float32)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=GRAD_REL * np.abs(r).max(),
                                       err_msg=str(i))


def test_the_fold_reads_the_y_it_is_given():
    """#9's plain version folds the y it is given, not a recomputed one: y
    moved by one bf16 ulp moves the folded dy (dyl) and with it dx and
    dW."""
    x, w, c, co, _, _, _ = _problem("1x1", 130)
    norm = [torch.tensor(v) for v in _norm(c, 131)]
    kshift = torch.tensor(rnd(co, seed=132, scale=0.05))
    bf = torch.bfloat16
    xt, wt = torch.tensor(x).to(bf), torch.tensor(w).to(bf)
    y = ck.plain_matmul_bn_fwd(xt, wt, *norm, kshift, fuse_input=True,
                               emit_stats=True)[0]
    dy = torch.tensor(rnd(x.shape[0], co, seed=133)).to(bf)
    gm, gs = torch.tensor(rnd(co, seed=134)), torch.tensor(rnd(co, seed=135))
    moved = (y.view(torch.int16) + 1).view(bf)     # one ulp from zero
    assert bool(((moved.float() - y.float()).abs() > 0).all())
    dyl, dyl_moved = (ck._fold(dy, t, kshift, gm, gs, True)
                      for t in (y, moved))
    assert not torch.equal(dyl, dyl_moved)
    base, other = (ck.plain_matmul_bn_bwd(xt, wt, *norm, kshift, t, dy, gm,
                                          gs, fuse_input=True,
                                          emit_stats=True)
                   for t in (y, moved))
    assert not torch.equal(base[0], other[0])    # dx
    assert not torch.equal(base[1], other[1])    # dW
    again = ck.plain_matmul_bn_bwd(xt, wt, *norm, kshift, y, dy, gm, gs,
                                   fuse_input=True, emit_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(base, again))
