"""The planning of the redesigned kernels #3 and #11, on the CPU: the
dtype routes, the dW split and scratch of #11's tensor-core route, the
checks chip_smoke.py holds them to, and the source lines the fault
controls of chip_gate_controls.py edit.  The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""

import math

import pytest
import torch

import chip_gate_controls as gates
import chip_smoke
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.ops import conv_bn_kernels as ck
from bigdl_tpu_torch.ops.build import CSRC_DIR

# ResNet-50's four stride-1 3x3 convs at b128, then the ragged ones of
# chip_smoke.conv_problems(), as (B, H, W, C, Co)
CONV3_SHAPES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                (128, 14, 14, 256, 256), (128, 7, 7, 512, 512),
                (3, 3, 7, 20, 72), (2, 3, 7, 4, 8), (1, 1, 1, 1, 1)]


def _mutant_sources():
    """(name, source file, the line as it stands) of every fault control."""
    rows = [(n, "flash_attention_bwd.cu", before)
            for n, (before, _, _) in gates.MUTANTS.items()]
    rows += [(n, path, before)
             for n, (path, _, before, _, _, _) in gates.CONV_MUTANTS.items()]
    rows += [(n, f"{lib}.cu", before)
             for n, (lib, before, _, _) in gates.RING_MUTANTS.items()]
    return rows


@pytest.mark.parametrize("name,path,before", _mutant_sources(),
                         ids=[r[0] for r in _mutant_sources()])
def test_each_fault_control_edits_one_line_of_its_source(name, path, before):
    text = (CSRC_DIR / path).read_text()
    assert text.count(before) == 1, (name, path)


def test_mutants_of_the_redesigned_kernels_edit_their_sources():
    """The #3 controls edit the tensor-core kernel, #7's the scalar
    template, and the two new #11 controls the tensor-core header."""
    tc = (CSRC_DIR / "flash_attention_bwd.cu").read_text()
    start = tc.index("flash_dkv_tc_kernel(const Params p)")
    end = tc.index("// ---- dBias")
    for name in ("no_ds_cast_in_dk", "no_p_cast_in_dv"):
        at = tc.index(gates.MUTANTS[name][0])
        assert start < at < end, name
    ring = gates.RING_MUTANTS["p_cast_to_q_dtype_in_7"][1]
    assert tc.index(ring) < tc.index("// ---- dK / dV on the tensor cores")
    for name in ("no_dyl_cast_in_11_prepass", "halo_copied_in_11"):
        assert gates.CONV_MUTANTS[name][0] == "conv_bn_tc.cuh", name


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_dtype_routes(dtype, route):
    assert ck.conv3x3_bwd_route(dtype) == route
    assert ak.dkv_route(dtype) == route


@pytest.mark.parametrize("fn", [ck.conv3x3_bwd_route, ak.dkv_route])
def test_routes_refuse_other_dtypes(fn):
    with pytest.raises(TypeError):
        fn(torch.float16)


def test_wrappers_count_each_route():
    assert set(ck.conv3x3_bn_bwd.routes) == {"tensor_core", "scalar"}
    assert set(ak.flash_attention_dkv.routes) == {"tensor_core", "scalar"}


def tc_splits(m, c, co):
    """The dW split count of #11's tensor-core route, as its wrapper asks
    dw_splits for it: 128-row tiles of the padded [9*Cp, Cop] dW, at least
    512 positions a part."""
    return ck.dw_splits(m, 9 * ck.tc_channels(c), ck.tc_channels(co),
                        ck._TC_ROWS, ck._TC_MIN_SPLIT_ROWS)


@pytest.mark.parametrize("shape", CONV3_SHAPES)
def test_tc_dw_splits_sum_every_position_once(shape):
    """Part s adds positions [s * chunk, (s + 1) * chunk) of M, as the
    wgrad kernel cuts them: every position once, whole 32-position
    stages but the last."""
    b, h, w, c, co = shape
    m = b * h * w
    splits = tc_splits(m, c, co)
    chunk = ck.tc_split_chunk(m, splits)
    assert 1 <= splits <= 65535 and chunk % 32 == 0
    covered = []
    for s in range(splits):
        covered.extend(range(s * chunk, min((s + 1) * chunk, m)))
    assert covered == list(range(m))
    assert (splits - 1) * chunk < m     # no split is empty


@pytest.mark.parametrize("shape", CONV3_SHAPES)
def test_tc_scratch_within_budget(shape):
    """The f32 dW partials within the scratch budget; z and dyl padded to
    64 channels, which ResNet-50's widths already are."""
    b, h, w, c, co = shape
    m = b * h * w
    cp, cop = ck.tc_channels(c), ck.tc_channels(co)
    assert cp % 64 == 0 and c <= cp < c + 64
    assert cop % 64 == 0 and co <= cop < co + 64
    splits = tc_splits(m, c, co)
    assert splits * 9 * cp * cop * 4 <= ck._MAX_PART_BYTES
    if c % 64 == 0 and co % 64 == 0:     # z and dyl: the size of x and dy
        assert (cp, cop) == (c, co)


def test_tc_dw_splits_fill_the_card_at_resnet_widths():
    """Enough 128 x 64 dW tiles in flight for every SM, at stage 1's
    56x56 as at stage 4's 7x7."""
    for b, h, w, c, co in CONV3_SHAPES[:4]:
        splits = tc_splits(b * h * w, c, co)
        tiles = -(-9 * ck.tc_channels(c) // 128) * (ck.tc_channels(co) // 64)
        assert splits * tiles >= 132, (c, splits, tiles)


def test_conv3x3_supported_takes_every_shape_it_took():
    """The tensor-core route refuses no shape: its limits are the scalar
    route's (fused_conv3x3_supported is unchanged)."""
    for _, h, w, c, co in CONV3_SHAPES:
        assert ck.fused_conv3x3_supported(h, w, c, co)


# ---- chip_smoke's rule for the bf16 dK/dV rows -------------------------------

def _bf16_grid(seed, shape=(1, 1, 512, 8)):
    """A dK-shaped [B, H, Tk, D] bf16 output; Tk 512 leaves the share at
    1%."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(torch.bfloat16)


def _next_up(t, steps=1):
    """t moved by ``steps`` bf16 ulps away from zero."""
    bits = t.view(torch.int16)
    return (bits + steps).view(torch.bfloat16)


def test_bwd_rule_passes_equal_outputs():
    want = _bf16_grid(0)
    assert chip_smoke.bwd_held("dkv", want.clone(), want)[2]


def test_bwd_rule_takes_a_few_entries_one_ulp_off():
    want = _bf16_grid(1)
    got = want.clone()
    got.view(-1)[:20] = _next_up(want.view(-1)[:20])   # 0.5% of them
    err, differ, ok = chip_smoke.bwd_held("dkv", got, want)
    assert ok and differ == 20


def test_bwd_rule_refuses_many_entries_one_ulp_off():
    """A dropped or truncated bf16 cast moves a large share of the
    entries by about an ulp: the share refuses it."""
    want = _bf16_grid(2)
    got = _next_up(want)
    assert not chip_smoke.bwd_held("dkv", got, want)[2]


def test_bwd_rule_refuses_one_entry_far_off():
    want = _bf16_grid(3)
    got = want.clone()
    top = float(want.float().abs().max())
    got.view(-1)[7] = (want.view(-1)[7].float()
                       + 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
                       ).to(torch.bfloat16)
    assert not chip_smoke.bwd_held("dkv", got, want)[2]


@pytest.mark.parametrize("shape,rows,held", [
    ((3, 2, 1, 8), 6, True),       # Tk 1: every key row may differ
    ((1, 2, 4, 8), 2, True),       # Tk 4: one key row a head
    ((1, 2, 4, 8), 3, False),
    ((1, 1, 200, 8), 2, True),     # Tk 200: 1% (16 entries) still rules
    ((1, 1, 200, 8), 3, False),
])
def test_bwd_rule_takes_one_key_row_a_head_where_tk_is_short(shape, rows,
                                                             held):
    """One P or dS on its other bf16 neighbour moves a key row of D
    entries: where Tk < 100 the share is one such row of each head."""
    want = _bf16_grid(5, shape)
    got = want.clone()
    flat_rows = got.view(-1, shape[-1])
    flat_rows[:rows] = _next_up(want.view(-1, shape[-1])[:rows])
    assert chip_smoke.bwd_held("dkv", got, want)[2] is held


def _dkv_case(shape, seed):
    """Plain bf16 dK, dV and their floors at [B, H, Tq, Tk, D], causal."""
    b, h, tq, tk, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(torch.bfloat16)
               for t in (tq, tk, tk))
    cfg = dict(scale=d ** -0.5, causal=True, causal_offset=tk - tq)
    out, lse = ak.plain_attention_fwd(q, k, v, None, **cfg)
    do = torch.randn(out.shape, generator=g).to(torch.bfloat16)
    args = (q, k, v, None, do, lse, ak.attention_delta(out, do))
    return ((ak.plain_attention_dq(*args, **cfg),
             *ak.plain_attention_dkv(*args, **cfg)),
            chip_smoke.bwd_floors(*args, **cfg))


@pytest.mark.parametrize("shape", [(1, 2, 64, 64, 16), (1, 2, 200, 250, 128),
                                   (2, 2, 256, 256, 64)])
def test_bwd_floors_stay_far_below_an_ulp_where_entries_carry_signal(shape):
    """The rounding floor never widens the rules where dQ, dK and dV are
    not noise: it stays under 2% of an ulp of the largest entry."""
    outs, floors = _dkv_case(shape, seed=1)
    for out, floor in zip(outs, floors):
        top = chip_smoke._bf16_ulp(out.float().abs().max())
        assert float(floor.max()) < 0.02 * float(top)


@pytest.mark.parametrize("kernel,which", [("dq", 0), ("dkv", 1)])
def test_bwd_floors_take_rounding_noise_where_dp_minus_delta_cancels(
        kernel, which):
    """Tk 1: dS = P·(dP − Δ) cancels in exact arithmetic on the one row
    that sees the key, so dQ and dK there are rounding noise; the floor
    takes a kernel's noise (the exact dQ rule, and the ulp rule at a
    largest entry of 0, would not) and still refuses an output that is
    not noise."""
    outs, floors = _dkv_case((3, 2, 5, 1, 8), seed=1)
    want, floor = outs[which], floors[which]
    seen = want[:, :, -1:] if kernel == "dq" else want   # dQ: the one row
    assert float(seen.float().abs().max()) < 1e-6        # noise or 0
    noise = want.clone()         # a kernel's noise: a share of the floor
    noise[:, :, -1] = (want[:, :, -1].float()
                       + 0.25 * floor[:, :, -1]).to(torch.bfloat16)
    assert not chip_smoke.bwd_held(kernel, noise, want)[2]
    assert chip_smoke.bwd_held(kernel, noise, want, floor)[2]
    signal = noise.clone()
    signal[:, :, -1] = (want[:, :, -1].float() + 1e-2).to(torch.bfloat16)
    assert not chip_smoke.bwd_held(kernel, signal, want, floor)[2]


def test_bwd_rule_keeps_dq_and_f32_exact_or_at_their_tolerance():
    want = _bf16_grid(4)
    got = want.clone()
    got.view(-1)[0] = _next_up(want.view(-1)[0])
    assert not chip_smoke.bwd_held("dq", got, want)[2]   # bit for bit
    f32 = want.float()
    assert chip_smoke.bwd_held("dkv", f32 * (1 + 1e-6), f32)[2]
    assert not chip_smoke.bwd_held("dkv", f32 * (1 + 1e-3), f32)[2]


# ---- chip_smoke's build report ----------------------------------------------

PTXAS = """\
ptxas info    : Compiling entry function '_Z9scalar_kernv' for 'sm_90a'
ptxas info    : Function properties for _Z9scalar_kernv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN6convbn6tcconv5dgradENS0_7ProblemE' for 'sm_90a'
ptxas info    : Function properties for _ZN6convbn6tcconv5dgradENS0_7ProblemE
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 48128 bytes smem
"""

SASS = """\
\tFunction : _ZN6convbn6tcconv5dgradENS0_7ProblemE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
\tFunction : _Z9scalar_kernv
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


def test_build_report_reads_registers_spills_and_smem():
    report = chip_smoke.ptxas_report(PTXAS)
    dgrad = report["_ZN6convbn6tcconv5dgradENS0_7ProblemE"]
    assert dgrad == {"registers": 80, "spill_stores": 8, "spill_loads": 8,
                     "smem": 48128}
    assert report["_Z9scalar_kernv"]["smem"] == 0


def test_build_report_counts_tensor_core_instructions():
    counts = chip_smoke.tensor_core_counts(SASS)
    assert counts == {"_ZN6convbn6tcconv5dgradENS0_7ProblemE": 2,
                      "_Z9scalar_kernv": 0}
