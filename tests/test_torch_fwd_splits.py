"""#1's f32-q kernels on the CPU: a model of the split-and-merge
arithmetic of the decode kernel (keys in splits of 128) and of the tile
kernel (tiles of 64 keys), the routing rule that picks them, and the
scratch they are given.  The kernels themselves run only on the card
(tests/test_torch_cuda.py); this file holds what their design rests on:
fixed part positions from key 0, each part its own softmax folded in key
order, the mixed entry's P normalised by the row's folded (m, l) before
its cast.  Only the test against the reference's xla_attention imports
JAX, inside it.

The model sums in a fixed order by elementwise operations alone, so a
row's bits can only depend on that row: (b) checks that the design keeps
them so under more rows, trailing masked keys and a fully masked leading
part.  Tolerances: F32_TOL (chip_smoke's) against the plain version and
the reference, the sums being taken in another order; the mixed entry by
chip_smoke.mixed_held."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.ops.build import CSRC_DIR

F32_TOL = chip_smoke.F32_TOL
DECODE_SPLIT, TILE_KEYS, TILE_ROWS = ak.FWD_LAYOUT


def split_model(q, k, v, bias=None, *, part, causal_offset=None,
                round_p="normalised"):
    """#1's f32-q kernels on the CPU: (out, lse).  The keys are cut into
    parts of ``part`` keys from key 0 (128: the decode kernel's splits,
    64: the tile kernel's tiles), padded to whole parts with keys that
    count for nothing.  Each part: s = q.k by a chain over d, scaled after
    the dot, the bias added, -1e9 in place of a causally masked score
    (``causal_offset`` set), its max m_s and l_s = sum exp(s - m_s).  f32
    K/V: each part's acc_s = exp(s - m_s).V, the parts folded in key order
    as the merge folds them, out = acc / l.  bf16 K/V (the mixed entry):
    the row's (m, l) folded first, P = exp(s - m) / l rounded to bf16
    (``round_p="unnormalised"``: rounded before the division, the fault
    the controls plant), the parts' P.V summed in key order."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    n = -(-tk // part)
    pad = n * part - tk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    s = torch.zeros(b, h, tq, n * part)
    for i in range(d):
        s = s + q[..., i:i + 1] * kf[..., i][..., None, :]
    s = s * (d ** -0.5)
    if bias is not None:
        s = s + torch.nn.functional.pad(
            bias.float().expand(b, h, tq, tk), (0, pad))
    if causal_offset is not None:
        rows = torch.arange(tq)[:, None] + causal_offset
        s = torch.where(torch.arange(n * part)[None, :] > rows,
                        torch.tensor(ak.NEG_INF), s)
    real = torch.arange(n * part) < tk
    s = torch.where(real, s, torch.tensor(-float("inf")))

    def parts():
        for i in range(n):
            yield i, s[..., i * part:(i + 1) * part], \
                vf[..., i * part:(i + 1) * part, :]

    def psum(p, vp):
        acc = torch.zeros(b, h, tq, d)
        for j in range(part):
            acc = acc + p[..., j:j + 1] * vp[..., j, :][..., None, :]
        return acc

    def total(e):
        t = torch.zeros(b, h, tq)
        for j in range(part):
            t = t + e[..., j]
        return t

    m = l = acc = None
    for i, sp, vp in parts():
        ms = sp.amax(-1)
        e = torch.exp(sp - ms[..., None])
        ls = total(e)
        if i == 0:
            m, l = ms, ls
            if k.dtype == torch.float32:
                acc = psum(e, vp)
            continue
        mn = torch.maximum(m, ms)
        a, bb = torch.exp(m - mn), torch.exp(ms - mn)
        l = ls * bb + l * a
        if k.dtype == torch.float32:
            acc = psum(e, vp) * bb[..., None] + acc * a[..., None]
        m = mn
    if k.dtype == torch.float32:
        return acc / l[..., None], (m + torch.log(l)).reshape(b * h, tq)
    acc = None
    for i, sp, vp in parts():
        e = torch.exp(sp - m[..., None])
        if round_p == "normalised":
            p = (e / l[..., None]).to(torch.bfloat16).float()
        else:
            p = e.to(torch.bfloat16).float() / l[..., None]
        part_sum = psum(p, vp)
        acc = part_sum if acc is None else acc + part_sum
    return acc, (m + torch.log(l)).reshape(b * h, tq)


def _inputs(b, h, tq, tk, d, kv, seed, masked=0.15):
    g = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(g.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    bias = torch.from_numpy(np.where(g.random((b, 1, tq, tk)) < masked,
                                     np.float32(-1e9), np.float32(0)))
    return q, k.to(kv), v.to(kv), bias


# (b, h, tq, tk, d, causal): the pooled decode cut in heads, a
# one-request decode, a ragged chunk over a ragged cache, a causal
# prefill with its diagonal offset
MODEL_CASES = [(16, 2, 1, 300, 32, False), (1, 2, 1, 517, 32, False),
               (2, 2, 33, 200, 32, False), (2, 2, 40, 70, 32, True)]


@pytest.mark.parametrize("part", [DECODE_SPLIT, TILE_KEYS],
                         ids=["decode", "tile"])
@pytest.mark.parametrize("case", MODEL_CASES)
def test_the_f32_model_lies_within_f32_tol_of_the_plain_version(case, part):
    b, h, tq, tk, d, causal = case
    q, k, v, bias = _inputs(b, h, tq, tk, d, torch.float32, seed=1)
    got, lse = split_model(q, k, v, bias, part=part,
                           causal_offset=tk - tq if causal else None)
    want, want_lse = ak.plain_attention_fwd(q, k, v, bias, scale=d ** -0.5,
                                            causal=causal,
                                            causal_offset=tk - tq)
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)


@pytest.mark.parametrize("part", [DECODE_SPLIT, TILE_KEYS],
                         ids=["decode", "tile"])
@pytest.mark.parametrize("case", MODEL_CASES[:3])
def test_the_mixed_model_is_held_by_the_mixed_rule(case, part):
    b, h, tq, tk, d, _ = case
    q, k, v, bias = _inputs(b, h, tq, tk, d, torch.bfloat16, seed=2)
    got, _ = split_model(q, k, v, bias, part=part)
    want = ak.plain_attention(q, k, v, bias)
    err, beyond, ok = chip_smoke.mixed_held(
        got, want, chip_smoke.mixed_anchor(q, k, v, bias))
    assert ok, (err, beyond)


@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16],
                         ids=["f32", "mixed"])
def test_the_model_lies_within_f32_tol_of_the_reference(kv):
    """The same numpy inputs through the reference's xla_attention (JAX,
    on the CPU): f32 within F32_TOL; bf16 K/V (xla_attention rounds the
    normalised weights to v's dtype, as the mixed entry does) held by the
    mixed rule with the reference's output as the plain version."""
    import jax.numpy as jnp

    from bigdl_tpu.ops.attention_kernels import xla_attention
    for part in (DECODE_SPLIT, TILE_KEYS):
        for b, h, tq, tk, d, causal in MODEL_CASES:
            q, k, v, bias = _inputs(b, h, tq, tk, d, kv, seed=3)
            got, _ = split_model(q, k, v, bias, part=part,
                                 causal_offset=tk - tq if causal else None)
            to_jax = (lambda t: jnp.asarray(t.float().numpy()).astype(
                jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32))
            want = torch.from_numpy(np.array(xla_attention(
                to_jax(q), to_jax(k), to_jax(v), jnp.asarray(bias.numpy()),
                causal=causal), dtype=np.float32))
            if kv == torch.float32:
                torch.testing.assert_close(got, want, **F32_TOL)
            else:
                assert chip_smoke.mixed_held(
                    got, want, chip_smoke.mixed_anchor(q, k, v, bias))[2]


@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16],
                         ids=["f32", "mixed"])
@pytest.mark.parametrize("part", [DECODE_SPLIT, TILE_KEYS],
                         ids=["decode", "tile"])
def test_a_row_keeps_its_bits_alone_and_over_masked_keys(part, kv):
    """A row among 6 equals the same row alone and over a Tk extended by
    keys its bias masks (one more part and a ragged one), bit for bit."""
    tq = 1 if part == DECODE_SPLIT else 5
    q, k, v, bias = _inputs(6, 2, tq, 300, 32, kv, seed=4)
    many, lse = split_model(q, k, v, bias, part=part)
    i = 3
    alone, lse1 = split_model(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                              bias[i:i + 1], part=part)
    extra = _inputs(1, 2, tq, part + 45, 32, kv, seed=5)
    longer, lse2 = split_model(
        q[i:i + 1], torch.cat([k[i:i + 1], extra[1]], 2),
        torch.cat([v[i:i + 1], extra[2]], 2),
        torch.cat([bias[i:i + 1], torch.full((1, 1, tq, part + 45), -1e9)],
                  -1), part=part)
    assert torch.equal(alone, many[i:i + 1]) and torch.equal(longer, alone)
    rows = lse.reshape(6, 2 * tq)[i].reshape(2, tq)
    assert torch.equal(lse1, rows) and torch.equal(lse2, rows)


@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16],
                         ids=["f32", "mixed"])
@pytest.mark.parametrize("part", [DECODE_SPLIT, TILE_KEYS],
                         ids=["decode", "tile"])
def test_a_fully_masked_leading_part_adds_nothing(part, kv):
    """A left-padded row whose first part is all masked keys equals, bit
    for bit, the row without that part: the part folds in with the weight
    exp(-1e9 - m) = 0 and its P.V is 0."""
    q, k, v, bias = _inputs(2, 2, 3, 2 * part + 17, 32, kv, seed=6)
    bias[..., :part] = -1e9
    got, lse = split_model(q, k, v, bias, part=part)
    want, want_lse = split_model(q, k[..., part:, :], v[..., part:, :],
                                 bias[..., part:], part=part)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("part", [DECODE_SPLIT, TILE_KEYS],
                         ids=["decode", "tile"])
def test_the_mixed_rule_refuses_p_rounded_before_it_is_normalised(part):
    tq = 1 if part == DECODE_SPLIT else 8
    q, k, v, bias = _inputs(16, 2, tq, 300, 32, torch.bfloat16, seed=7)
    want = ak.plain_attention(q, k, v, bias)
    anchor = chip_smoke.mixed_anchor(q, k, v, bias)
    assert chip_smoke.mixed_held(split_model(q, k, v, bias, part=part)[0],
                                 want, anchor)[2]
    bad, _ = split_model(q, k, v, bias, part=part, round_p="unnormalised")
    assert not chip_smoke.mixed_held(bad, want, anchor)[2]


# ---- the routing rule and the scratch ------------------------------------

def test_the_routing_rule_picks_the_kernel_by_rows_and_tq():
    f32, bf = torch.float32, torch.bfloat16
    assert ak.fwd_kernel(f32, True, f32, 1) == "decode"
    assert ak.fwd_kernel(f32, True, f32, 2) == "tile"
    assert ak.fwd_kernel(f32, True, bf, 1) == "decode"
    assert ak.fwd_kernel(f32, True, bf, 128) == "tile"
    assert ak.fwd_kernel(f32, False, f32, 1) == "scalar_template"
    assert ak.fwd_kernel(f32, False, bf, 128) == "scalar_template"
    assert ak.fwd_kernel(bf, True, bf, 1) == "tensor_core"
    assert ak.fwd_kernel(bf, False, bf, 64) == "scalar_template"
    with pytest.raises(TypeError):
        ak.fwd_kernel(bf, True, f32, 1)
    # 16-byte rows: D a multiple of 4 in f32, of 8 with bf16 K/V, the
    # strides too; the model's head layout ([B, T, H, D] viewed) is aligned
    q = torch.zeros(2, 4, 1, 36)
    assert ak.rows_aligned(q, q, q)
    assert not ak.rows_aligned(q, q.bfloat16(), q.bfloat16())   # 72 bytes
    heads = torch.zeros(2, 96, 4, 64).transpose(1, 2)
    assert ak.rows_aligned(heads[:, :, :1], heads, heads)
    odd = torch.zeros(2, 4, 9, 34)
    assert not ak.rows_aligned(odd, odd, odd)
    kernels = [ak.fwd_kernel(torch.float32, ak.rows_aligned(x, x, x),
                             torch.float32, x.shape[2])
               for x in (q, odd, heads)]
    assert kernels == ["decode", "scalar_template", "tile"]


@pytest.mark.parametrize("kernel,mixed,shape,sms,split,floats", [
    # the pooled decode: 4 splits merged (acc, m, l), + the scores mixed
    ("decode", False, (16, 8, 1, 512, 64), 132, False, 128 * 4 * 66),
    ("decode", True, (16, 8, 1, 512, 64), 132, False,
     128 * 4 * 66 + 128 * 512),
    # one split: no parts, the mixed scores in shared memory
    ("decode", True, (32, 8, 1, 128, 64), 132, False, 0),
    # the chunk: 8 x 4 row blocks < 132 SMs, its 8 tiles spread and merged
    ("tile", False, (1, 8, 128, 512, 64), 132, True, 1024 * 8 * 66),
    ("tile", True, (1, 8, 128, 512, 64), 132, True,
     1024 * 8 * 66 + 1024 * 512),
    # enough row blocks: the tiles in one block; mixed keeps its scores
    ("tile", False, (5, 8, 128, 512, 64), 132, False, 0),
    ("tile", True, (5, 8, 128, 512, 64), 132, False, 5 * 8 * 128 * 512),
    # one tile: nothing to merge
    ("tile", False, (1, 1, 40, 64, 32), 132, False, 0),
    ("scalar_template", False, (1, 8, 128, 512, 64), 132, False, 0),
])
def test_the_scratch_plan(kernel, mixed, shape, sms, split, floats):
    assert ak.fwd_scratch(kernel, mixed, *shape, sms) == (split, floats)


def test_the_part_positions_match_the_source():
    src = (CSRC_DIR / "flash_attention_fwd.cu").read_text()
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
             for name in ("kSplitKeys", "kTileKeys", "kTileRowsW",
                          "kTileWarps")}
    assert ak.FWD_LAYOUT == (found["kSplitKeys"], found["kTileKeys"],
                             found["kTileRowsW"] * found["kTileWarps"])
