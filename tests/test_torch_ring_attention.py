"""The port's ring attention (``bigdl_tpu_torch.parallel``) and the plain
versions of its kernels #5-#7 against the JAX package, on the same numpy
inputs:

* ``plain_attention_partial``/``_dq_partial``/``_dkv_partial`` against
  the Pallas ``flash_attention_partial``/``_dq_partial``/``_dkv_partial``
  in interpret mode (B1 H2 Tc16 D8; a diagonal, an off-diagonal and a
  non-causal pair; f32 and bf16 q/k/v with f32 dO; a carried state taken
  from an earlier merge);
* ``ring_self_attention`` with ``kernel="flash"`` (the autograd Function
  over the plain versions, on CPU tensors) and ``kernel="plain"``
  against the reference's ``ring_self_attention(kernel="flash")`` on a
  4-device ``seq`` mesh: forward at T64 D16, q/k/v gradients at T64 D8,
  causal and not, and the bias route;
* the mesh and the ring's refusals.

Tolerances.  Partials, f32: rtol 1e-5, atol 1e-5 -- one block per chunk
on both sides, so only the f32 summation order differs.  bf16: P is
rounded to bf16 at the same points on both sides, but a one-ulp f32
difference before the cast moves a bf16 P by one ulp (2^-8), so the
state's acc and the backward's outputs are held to 1e-2 of their largest
entry; m and l, which sum unrounded f32, stay at rtol 1e-5.  The ring:
forward rtol 1e-4, atol 1e-5 and gradients rtol 1e-3, atol 1e-4, the
reference's own bounds (tests/test_parallel.py:38-100).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them to these plain versions there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from bigdl_tpu.ops import attention_kernels as jak
from bigdl_tpu.parallel.ring_attention import \
    ring_self_attention as jax_ring
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.parallel import (AXES, Mesh, make_mesh,
                                      ring_attention, ring_self_attention)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2
RING_FWD = dict(rtol=1e-4, atol=1e-5)
RING_GRAD = dict(rtol=1e-3, atol=1e-4)
B, H, TC, D = 1, 2, 16, 8
# (name, q_offset, k_offset, causal)
PAIRS = [("diagonal", 16, 16, True), ("off_diagonal", 32, 0, True),
         ("non_causal", 16, 48, False)]


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, dtype=np.float32)).to(dtype)


def j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, dtype=np.float32)).astype(dtype)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_rel(got, want, rel, what):
    """|got - want| <= rel * max|want|."""
    got, want = np32(got), np32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def seq_mesh():
    with JaxMesh(np.array(jax.devices()[:4]), ("seq",)) as m:
        yield m


def _carried_state(q, k, v, tdtype):
    """The state after merging a first visiting chunk (a diagonal pair at
    position 16) into the fresh one, on the port's plain version."""
    acc = torch.zeros(B, H, TC, D)
    m = torch.full((B, H, TC), ak.NEG_INF)
    l = torch.zeros(B, H, TC)
    return ak.plain_attention_partial(
        t(q, tdtype), t(k, tdtype), t(v, tdtype), acc, m, l, q_offset=16,
        k_offset=16, scale=D ** -0.5, causal=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,q_off,k_off,causal", PAIRS)
def test_plain_partial_matches_pallas(name, q_off, k_off, causal, dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q, k, v = (rnd(B, H, TC, D, seed=s) for s in (1, 2, 3))
    k0, v0 = rnd(B, H, TC, D, seed=4), rnd(B, H, TC, D, seed=5)
    acc, m, l = _carried_state(q, k0, v0, tdt)
    scale = D ** -0.5
    got = ak.plain_attention_partial(t(q, tdt), t(k, tdt), t(v, tdt), acc,
                                     m, l, q_offset=q_off, k_offset=k_off,
                                     scale=scale, causal=causal)
    want = jak.flash_attention_partial(
        j(q, jdt), j(k, jdt), j(v, jdt), j(np32(acc)), j(np32(m)),
        j(np32(l)), q_offset=q_off, k_offset=k_off, causal=causal,
        scale=scale, interpret=True)
    for label, g, w in zip(("m", "l"), got[1:], want[1:]):
        np.testing.assert_allclose(np32(g), np32(w), **F32, err_msg=label)
    if dtype == "f32":
        np.testing.assert_allclose(np32(got[0]), np32(want[0]), **F32)
    else:
        assert_rel(got[0], want[0], BF16_REL, "acc")


def test_plain_partial_passes_a_chunk_above_the_diagonal():
    q, k, v = (rnd(B, H, TC, D, seed=s) for s in (1, 2, 3))
    acc, m, l = _carried_state(q, q, q, torch.float32)
    got = ak.plain_attention_partial(t(q), t(k), t(v), acc, m, l,
                                     q_offset=0, k_offset=16,
                                     scale=D ** -0.5, causal=True)
    for g, w in zip(got, (acc, m, l)):
        assert torch.equal(g, w)


def _lse_delta(q, k, v, tdt, q_off, k_off, causal):
    """A finite whole-sequence lse and Δ for the rows of q: this chunk's
    own logsumexp plus log 2 (as if other chunks weighed as much), Δ
    small and random."""
    acc = torch.zeros(B, H, TC, D)
    m = torch.full((B, H, TC), ak.NEG_INF)
    _, m, l = ak.plain_attention_partial(
        t(q, tdt), t(k, tdt), t(v, tdt), acc, m, torch.zeros(B, H, TC),
        q_offset=q_off, k_offset=k_off, scale=D ** -0.5, causal=causal)
    lse = m + torch.log(torch.where(l == 0, 1.0, l)) + float(np.log(2.0))
    return lse, t(rnd(B, H, TC, seed=9, scale=0.1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,q_off,k_off,causal", PAIRS)
def test_plain_partial_backward_matches_pallas(name, q_off, k_off, causal,
                                               dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q, k, v = (rnd(B, H, TC, D, seed=s) for s in (11, 12, 13))
    do = rnd(B, H, TC, D, seed=14)
    # the diagonal chunk's own lse: every row sees a key there
    lse, delta = _lse_delta(q, q, v, tdt, q_off, q_off, causal)
    scale = D ** -0.5
    targs = (t(q, tdt), t(k, tdt), t(v, tdt), t(do), lse, delta)
    cfg = dict(q_offset=q_off, k_offset=k_off, scale=scale, causal=causal)
    got = [ak.plain_attention_dq_partial(*targs, **cfg),
           *ak.plain_attention_dkv_partial(*targs, **cfg)]
    jargs = (j(q, jdt), j(k, jdt), j(v, jdt), j(do), j(np32(lse)),
             j(np32(delta)))
    jcfg = dict(q_offset=q_off, k_offset=k_off, causal=causal, scale=scale,
                block_q=None, block_k=None, interpret=True)
    want = [jak.flash_attention_dq_partial(*jargs, **jcfg),
            *jak.flash_attention_dkv_partial(*jargs, **jcfg)]
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        if dtype == "f32":
            np.testing.assert_allclose(np32(g), np32(w), **F32,
                                       err_msg=label)
        else:
            assert_rel(g, w, BF16_REL, label)


def test_partial_backward_keeps_dv_in_f32_where_the_dense_rule_rounds():
    """#7 takes P in dO's dtype (f32): with bf16 q/k/v its dV differs from
    what the dense kernel's rule (P in q's dtype) would give."""
    q, k, v, do = (rnd(B, H, TC, D, seed=s) for s in (21, 22, 23, 24))
    bf = torch.bfloat16
    lse, delta = _lse_delta(q, k, v, bf, 0, 0, False)
    args = (t(q, bf), t(k, bf), t(v, bf), t(do), lse, delta)
    cfg = dict(q_offset=0, k_offset=0, scale=D ** -0.5, causal=False)
    _, dv = ak.plain_attention_dkv_partial(*args, **cfg)
    _, dv_bf = ak.plain_attention_dkv_partial(*args[:3], t(do, bf),
                                              *args[4:], **cfg)
    assert dv.dtype == torch.float32
    assert not torch.equal(dv, dv_bf.float())


def _ring_inputs(shape, seeds):
    return [rnd(*shape, seed=s) for s in seeds]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["flash", "plain"])
def test_ring_forward_matches_reference(seq_mesh, kernel, causal):
    q, k, v = _ring_inputs((2, 2, 64, 16), (31, 32, 33))
    want = jax_ring(j(q), j(k), j(v), seq_mesh, causal=causal,
                    kernel="flash")
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    got = ring_self_attention(t(q), t(k), t(v), mesh, causal=causal,
                              kernel=kernel)
    np.testing.assert_allclose(np32(got), np32(want), **RING_FWD)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["flash", "plain"])
def test_ring_grads_match_reference(seq_mesh, kernel, causal):
    q, k, v = _ring_inputs((1, 2, 64, 8), (34, 35, 36))
    w = rnd(1, 2, 64, 8, seed=37)
    want = jax.grad(lambda *a: jnp.sum(jax_ring(
        *a, seq_mesh, causal=causal, kernel="flash") * j(w)),
        argnums=(0, 1, 2))(j(q), j(k), j(v))
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    (ring_self_attention(*ins, mesh, causal=causal, kernel=kernel)
     * t(w)).sum().backward()
    for name, x, g in zip("qkv", ins, want):
        np.testing.assert_allclose(np32(x.grad), np32(g), **RING_GRAD,
                                   err_msg=f"d{name}")


def test_ring_bias_route_matches_reference(seq_mesh):
    q, k, v = _ring_inputs((2, 2, 64, 16), (41, 42, 43))
    bias = rnd(2, 1, 64, 64, seed=44)
    want = jax_ring(j(q), j(k), j(v), seq_mesh, bias=j(bias))
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    got = ring_self_attention(t(q), t(k), t(v), mesh, bias=t(bias),
                              kernel="flash")
    np.testing.assert_allclose(np32(got), np32(want), **RING_FWD)


def test_flash_ring_on_cpu_runs_the_plain_versions(monkeypatch):
    """kernel="flash" on CPU tensors calls #5-#7's plain versions once per
    visible pair: 10 of 16 at 4 causal shards."""
    calls = {}

    def counting(fn):
        def run(*a, **kw):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(ak, "_RING_PLAIN",
                        tuple(counting(f) for f in ak._RING_PLAIN))
    q = t(rnd(1, 2, 64, 8, seed=51)).requires_grad_()
    ring_attention(q, q, q, 4, causal=True, kernel="flash").sum().backward()
    assert calls == {"plain_attention_partial": 10,
                     "plain_attention_dq_partial": 10,
                     "plain_attention_dkv_partial": 10}
    calls.clear()
    ring_attention(q, q, q, 4, causal=False, kernel="flash")
    assert calls == {"plain_attention_partial": 16}


def test_mesh_axes_and_refusals():
    assert AXES == ("dcn", "data", "fsdp", "model", "pipe", "seq", "expert")
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    assert mesh.shape == {"seq": 4} and mesh.device == torch.device("cpu")
    assert make_mesh({"seq": -1}, ["cpu"] * 2).shape["seq"] == 2
    assert Mesh(np.array(["cpu"] * 4).reshape(2, 2),
                ("data", "seq")).shape == {"data": 2, "seq": 2}
    with pytest.raises(NotImplementedError, match="item 11"):
        make_mesh({"data": 2, "seq": 2}, ["cpu"] * 4)
    with pytest.raises(ValueError, match="distinct axis names"):
        Mesh(["cpu"] * 2, ("seq", "seq"))
    with pytest.raises(ValueError, match="needs the devices"):
        make_mesh({"seq": -1})
    with pytest.raises(ValueError, match="need 1 to 2"):
        make_mesh({"seq": 3}, ["cpu"] * 2)


def test_mesh_over_distinct_devices_is_not_ported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="item 11"):
        Mesh(["cpu", "cuda"], ("seq",))
    with pytest.raises(NotImplementedError, match="item 11"):
        Mesh(["cuda:0", "cuda:1"], ("seq",))
    assert Mesh(["cuda", "cuda:0"], ("seq",)).shape == {"seq": 2}


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"seq": 4})


def test_ring_refusals():
    mesh = make_mesh({"seq": 4}, ["cpu"] * 4)
    x = torch.zeros(1, 2, 64, 8)
    with pytest.raises(NotImplementedError, match="item 11"):
        ring_self_attention(x, x, x, mesh, head_axis="model")
    with pytest.raises(ValueError, match="no axis 'data'"):
        ring_self_attention(x, x, x, mesh, "data")
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(torch.zeros(1, 2, 63, 8), torch.zeros(1, 2, 63, 8),
                       torch.zeros(1, 2, 63, 8), 4)
    with pytest.raises(ValueError, match="kernel must be"):
        ring_attention(x, x, x, 4, kernel="xla")
    with pytest.raises(ValueError, match="one shape"):
        ring_self_attention(x, torch.zeros(1, 2, 32, 8),
                            torch.zeros(1, 2, 32, 8), mesh)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch kernels on CUDA tensors only; the ring gives
    CPU tensors to the plain versions instead."""
    x = torch.zeros(1, 2, 16, 8)
    m = torch.zeros(1, 2, 16)
    cfg = dict(q_offset=0, k_offset=0, scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.flash_attention_partial(x, x, x, x, m, m, **cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.flash_attention_dq_partial(x, x, x, x, m, m, **cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.flash_attention_dkv_partial(x, x, x, x, m, m, **cfg)
