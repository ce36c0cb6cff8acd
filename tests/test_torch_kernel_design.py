"""The planning of the redesigned kernels #1-#3 and #5-#11, on the CPU:
the dtype routes, the dW split and scratch of #11's and #9's tensor-core
routes and the scratch of #10's and #8's, the checks chip_smoke.py holds
them to (with CPU models of #5's tiled merge and #1's tiled forward for
their bf16 bias rule, of #7's and #6's split-bf16 routes for their ulp
and dV rules, of #2 with dS truncated and of #9's fold of the saved y),
the three-piece bf16 split #6 and #7 rest on, and the source lines the
fault controls of chip_gate_controls.py edit.  The kernels themselves run
only on the card (tests/test_torch_cuda.py).  Only the tests that hold
#7's and #6's models against the Pallas kernels import JAX, inside
them."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
# ResNet-50's 1x1 convs at b128 as (M, K, N): each stage's conv1 and conv3
# and the widths of its first block's conv1, then chip_smoke's ragged one
# and a one-row one
MATMUL_SHAPES = [(128 * 56 * 56, 64, 64), (128 * 56 * 56, 64, 256),
                 (128 * 56 * 56, 256, 64), (128 * 28 * 28, 256, 128),
                 (128 * 28 * 28, 512, 128), (128 * 28 * 28, 128, 512),
                 (128 * 14 * 14, 1024, 256), (128 * 14 * 14, 256, 1024),
                 (128 * 7 * 7, 2048, 512), (128 * 7 * 7, 512, 2048),
                 (100, 24, 72), (1, 1, 1)]


def _mutant_sources():
    """(name, source file, the line as it stands) of every fault control."""
    rows = [(n, "flash_attention_bwd.cu", before)
            for n, (before, _, _) in gates.MUTANTS.items()]
    rows += [(n, path, before)
             for n, (path, _, before, _, _, _) in gates.CONV_MUTANTS.items()]
    rows += [(n, f"{lib}.cu", before)
             for n, (lib, before, _, _) in gates.RING_MUTANTS.items()]
    rows += [(n, "flash_attention_fwd.cu", before)
             for n, (before, _) in gates.FWD_MUTANTS.items()]
    rows += [(f"{n}_{i}", f"{lib}.cu", before)
             for n, (lib, edits, _, _) in gates.VARIANTS.items()
             for i, (before, _) in enumerate(edits)]
    return rows


@pytest.mark.parametrize("name,path,before", _mutant_sources(),
                         ids=[r[0] for r in _mutant_sources()])
def test_each_fault_control_edits_one_line_of_its_source(name, path, before):
    text = (CSRC_DIR / path).read_text()
    assert text.count(before) == 1, (name, path)


def test_mutants_of_the_redesigned_kernels_edit_their_sources():
    """The #3 controls edit its tensor-core kernel, #2's and #6's the dQ
    loop they share (dS's pack), #7's its split tensor-core kernel (P's
    pieces) and, with #6's, the split of dO's rows both call, the #8-#11
    tensor-core controls the tensor-core header (each built into its own
    library; #9's in the prepass that folds the saved y, #8's y cast in
    fprop's epilogue), #10's halo-before-norm control and #8's f32
    control the f32 routes, #5's and #1's truncation the tensor-core loop
    they share and #5's causal offset the entry point that sets it for
    both routes."""
    tc = (CSRC_DIR / "flash_attention_bwd.cu").read_text()
    start = tc.index("flash_dkv_tc_kernel(const Params p)")
    end = tc.index("// ---- dQ on the tensor cores")
    for name in ("no_ds_cast_in_dk", "no_p_cast_in_dv"):
        at = tc.index(gates.MUTANTS[name][0])
        assert start < at < end, name
    start = tc.index("flash_dq_tc_kernel(const Params p)")
    end = tc.index("// ---- the ring's dK / dV (#7) on the tensor cores")
    assert start < tc.index(gates.MUTANTS["no_ds_cast_in_dq"][0]) < end
    assert gates.RING_MUTANTS["no_ds_cast_in_6"] == (
        "flash_attention_bwd", *gates.MUTANTS["no_ds_cast_in_dq"][:2],
        "dq_partial")
    header = (CSRC_DIR / "conv_bn_tc.cuh").read_text()
    start = header.index("// ---- 1. the prepass")
    end = header.index("// ---- the product tiles")
    for name in ("saved_y_ignored_in_9", "no_dyl_cast_in_9"):
        path, library, before, _, key, _ = gates.CONV_MUTANTS[name]
        assert (path, library, key) == ("conv_bn_tc.cuh", "conv_bn_bwd",
                                        "s1_conv3"), name
        assert start < header.index(before) < end, name
    for name, region in (("no_z_cast_in_8", ("z_entry(", "dyl_entry(")),
                         ("no_y_cast_in_8", ("fprop(const Problem p)",
                                             "}  // namespace tcconv"))):
        path, library, before, _, key, _ = gates.CONV_MUTANTS[name]
        assert (path, library, key) == ("conv_bn_tc.cuh", "conv_bn_fwd",
                                        "s1_conv3"), name
        at = header.index(before)
        assert header.index(region[0]) < at < header.index(region[1]), name
    start = tc.index("flash_dkv_partial_tc_kernel(const Params p)")
    end = tc.index("// ---- dBias")
    library, before, _, kernel = gates.RING_MUTANTS["p_cast_to_q_dtype_in_7"]
    assert (library, kernel) == ("flash_attention_bwd", "dkv_partial")
    assert start < tc.index(before) < end
    start = tc.index("split_rows(const float* src")
    end = tc.index("// ---- dQ on the tensor cores")
    for name, kernel in (("no_do_split_in_7", "dkv_partial"),
                         ("no_do_split_in_6", "dq_partial")):
        library, before, _, which = gates.RING_MUTANTS[name]
        assert (library, which) == ("flash_attention_bwd", kernel)
        assert start < tc.index(before) < end, name
    # #6's and #7's kernels both split dO's rows by split_rows
    for kernel in ("flash_dq_tc_kernel(const Params p)",
                   "flash_dkv_partial_tc_kernel(const Params p)"):
        assert "split_rows<DMAX>(" in tc[tc.index(kernel):]
    for name, library in (("no_dyl_cast_in_11_prepass", "conv_bn_bwd"),
                          ("halo_copied_in_11", "conv_bn_bwd"),
                          ("no_z_cast_in_10_prepass", "conv_bn_fwd"),
                          ("halo_copied_in_10", "conv_bn_fwd")):
        assert gates.CONV_MUTANTS[name][:2] == ("conv_bn_tc.cuh",
                                                library), name
    conv = (CSRC_DIR / "conv_bn_fwd.cu").read_text()
    before = gates.CONV_MUTANTS["halo_zeroed_before_norm_in_10"][2]
    assert conv.index("struct Conv3Fwd") < conv.index(before)
    before = gates.CONV_MUTANTS["z_cast_to_bf16_in_8_f32"][2]
    assert conv.index("struct MatmulFwd") < conv.index(before) < \
        conv.index("struct Conv3Fwd")
    f32_keys = {key for key, _, _, dtype, _ in chip_smoke.conv_problems()
                if dtype == torch.float32}
    for name in ("halo_zeroed_before_norm_in_10", "z_cast_to_bf16_in_8_f32"):
        assert gates.CONV_MUTANTS[name][4] in f32_keys, name
    fwd = (CSRC_DIR / "flash_attention_fwd.cu").read_text()
    start = fwd.index("flash_fwd_tc_kernel(const Params p)")
    end = fwd.index("int launch_tc(")
    assert start < fwd.index(gates.RING_MUTANTS["p_truncated_in_5"][1]) < end
    assert gates.FWD_MUTANTS["p_truncated_in_1"][0] == \
        gates.RING_MUTANTS["p_truncated_in_5"][1]
    entry = fwd.index('extern "C" int flash_attention_partial(')
    assert entry < fwd.index(gates.RING_MUTANTS["local_mask_in_5"][1])


# the route functions of the redesigned kernels, beside their wrappers:
# #11 and #3, then #10 and #5, then #1 and #7, then #2 and #9, then #6
# and #8
ROUTES = [(ck.conv3x3_bwd_route, ck.conv3x3_bn_bwd),
          (ak.dkv_route, ak.flash_attention_dkv),
          (ck.conv3x3_fwd_route, ck.conv3x3_bn_fwd),
          (ak.partial_route, ak.flash_attention_partial),
          (ak.fwd_route, ak.flash_attention_fwd),
          (ak.dkv_partial_route, ak.flash_attention_dkv_partial),
          (ak.dq_route, ak.flash_attention_dq),
          (ck.matmul_bwd_route, ck.matmul_bn_bwd),
          (ak.dq_partial_route, ak.flash_attention_dq_partial),
          (ck.matmul_fwd_route, ck.matmul_bn_fwd)]


@pytest.mark.parametrize("fns,dtype,route", [
    (ROUTES[:2], torch.bfloat16, "tensor_core"),
    (ROUTES[:2], torch.float32, "scalar"),
    (ROUTES[2:4], torch.bfloat16, "tensor_core"),
    (ROUTES[2:4], torch.float32, "scalar"),
    (ROUTES[4:6], torch.bfloat16, "tensor_core"),
    (ROUTES[4:6], torch.float32, "scalar"),
    (ROUTES[6:8], torch.bfloat16, "tensor_core"),
    (ROUTES[6:8], torch.float32, "scalar"),
    (ROUTES[8:], torch.bfloat16, "tensor_core"),
    (ROUTES[8:], torch.float32, "scalar"),
], ids=["dtype0-tensor_core", "dtype1-scalar", "fwd-bf16", "fwd-f32",
        "ring-bf16", "ring-f32", "dq-matmul-bwd-bf16",
        "dq-matmul-bwd-f32", "dq-partial-matmul-fwd-bf16",
        "dq-partial-matmul-fwd-f32"])
def test_dtype_routes(fns, dtype, route):
    for fn, _ in fns:
        assert fn(dtype) == route, fn.__name__


@pytest.mark.parametrize("fn", [fn for fn, _ in ROUTES])
def test_routes_refuse_other_dtypes(fn):
    with pytest.raises(TypeError):
        fn(torch.float16)


@pytest.mark.parametrize("wrapper", [w for _, w in ROUTES],
                         ids=[w.__name__ for _, w in ROUTES])
def test_wrappers_count_each_route(wrapper):
    assert set(wrapper.routes) == {"tensor_core", "scalar"}


def test_partial_route_sends_unaligned_bf16_rows_to_the_scalar_kernel():
    """#5's tensor-core copies move 16 bytes: bf16 rows that do not start
    on 16 bytes take the scalar kernel (and count as its launches), never
    the plain version."""
    assert ak.partial_route(torch.bfloat16, False) == "scalar"
    assert ak.partial_route(torch.float32, False) == "scalar"
    x = torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16)
    heads = torch.zeros(2, 96, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    # chunks of the time axis and the heads view of [B, T, H, D], D40
    assert ak.rows_aligned(x, x[:, :, 32:64], heads[:, :, 8:])
    assert ak.rows_aligned(x[..., :40], x[..., :40], x[..., :40])
    odd = torch.zeros(2, 4, 96, 36, dtype=torch.bfloat16)     # D % 8 != 0
    assert not ak.rows_aligned(odd, odd, odd)
    wide = torch.zeros(2, 4, 96, 68, dtype=torch.bfloat16)[..., :64]
    assert not ak.rows_aligned(x, wide, x)                    # stride 68
    ragged = torch.zeros(2 * 4 * 96 * 40 + 4, dtype=torch.bfloat16)[4:] \
        .reshape(2, 4, 96, 40)                                 # 8-byte start
    assert not ak.rows_aligned(ragged, x[..., :40], x[..., :40])


@pytest.mark.parametrize("route", [ak.fwd_route, ak.dkv_partial_route,
                                   ak.dq_partial_route])
def test_fwd_and_ring_dkv_routes_send_unaligned_bf16_rows_to_the_scalar_kernel(
        route):
    """#1's, #7's and #6's tensor-core copies move 16 bytes: bf16 rows
    that do not start on 16 bytes (q, k, v at D36; #6's and #7's f32 dO at
    a stride that is not a whole number of 16 bytes) take the scalar
    kernel, never the plain version."""
    assert route(torch.bfloat16, False) == "scalar"
    assert route(torch.float32, False) == "scalar"
    odd = torch.zeros(2, 4, 96, 36, dtype=torch.bfloat16)
    assert not ak.rows_aligned(odd, odd, odd)
    x = torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16)
    do = torch.zeros(2, 4, 96, 64)
    assert ak.rows_aligned(x, x, x, do)
    assert ak.rows_aligned(x, x, x, torch.zeros(2, 4, 96, 36)[..., :36])
    assert not ak.rows_aligned(x, x, x, torch.zeros(2, 4, 96, 66)[..., :64])
    assert not ak.rows_aligned(x, x, x, torch.zeros(4 * 96 * 128 + 2)[2:]
                               .reshape(1, 4, 96, 128)[..., :64])


def tc_splits(m, c, co):
    """The dW split count of #11's tensor-core route, as its wrapper plans
    it: 128-row tiles of the padded [9*Cp, Cop] dW, at least 512 positions
    a part."""
    return ck.tc_split_plan(m, 9 * ck.tc_channels(c), ck.tc_channels(co))[0]


@pytest.mark.parametrize("shape", CONV3_SHAPES)
def test_tc_dw_splits_sum_every_position_once(shape):
    """Part s adds positions [s * chunk, (s + 1) * chunk) of M, as the
    wgrad kernel cuts them: every position once, whole 32-position
    stages but the last."""
    b, h, w, c, co = shape
    m = b * h * w
    splits, chunk = ck.tc_split_plan(m, 9 * ck.tc_channels(c),
                                     ck.tc_channels(co))
    assert splits == tc_splits(m, c, co)
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


@pytest.mark.parametrize("shape", CONV3_SHAPES)
def test_tc_fwd_scratch_within_budget(shape):
    """#10's tensor-core scratch, as its wrapper allocates it: z [M, Cp]
    and the padded W [9, Cp, Cop] in bf16 and the f32 statistics partials
    of 128-row tiles, within the budget of #11's dW partials (z at
    stage 1, b128: 51 MB)."""
    b, h, w, c, co = shape
    m = b * h * w
    cp, cop = ck.tc_channels(c), ck.tc_channels(co)
    scratch = (m * cp + 9 * cp * cop) * 2 + 2 * -(-m // ck._TC_ROWS) * co * 4
    assert scratch <= ck._MAX_PART_BYTES


def test_tc_dw_splits_fill_the_card_at_resnet_widths():
    """Enough 128 x 64 dW tiles in flight for every SM, at stage 1's
    56x56 as at stage 4's 7x7."""
    for b, h, w, c, co in CONV3_SHAPES[:4]:
        splits = tc_splits(b * h * w, c, co)
        tiles = -(-9 * ck.tc_channels(c) // 128) * (ck.tc_channels(co) // 64)
        assert splits * tiles >= 132, (c, splits, tiles)


def matmul_splits(m, k, n):
    """``(splits, chunk)`` of #9's tensor-core dW sum, as its wrapper plans
    it: 128-row tiles of the padded [Kp, Np] dW, at least 512 rows a
    part."""
    return ck.tc_split_plan(m, ck.tc_channels(k), ck.tc_channels(n))


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_one_tap_dw_splits_sum_every_row_once(shape):
    """#9's wgrad cuts M as #11's cuts its positions: part s adds rows
    [s * chunk, (s + 1) * chunk), every row once, whole 32-row stages but
    the last, no part empty."""
    m, k, n = shape
    splits, chunk = matmul_splits(m, k, n)
    assert 1 <= splits <= 65535 and chunk % 32 == 0
    covered = []
    for s in range(splits):
        covered.extend(range(s * chunk, min((s + 1) * chunk, m)))
    assert covered == list(range(m))
    assert (splits - 1) * chunk < m


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_one_tap_scratch_within_budget(shape):
    """#9's tensor-core scratch as its wrapper allocates it: the f32 dW
    partials within the budget; z, dyl and the padded W in bf16 no larger
    than the partials' budget; at ResNet-50's widths (multiples of 64) z
    and dyl are exactly x's and dy's size, and the card is filled."""
    m, k, n = shape
    kp, np_ = ck.tc_channels(k), ck.tc_channels(n)
    splits, _ = matmul_splits(m, k, n)
    assert splits * kp * np_ * 4 <= ck._MAX_PART_BYTES
    assert (m * (kp + np_) + kp * np_) * 2 <= ck._MAX_PART_BYTES
    if k % 64 == 0 and n % 64 == 0:
        assert (kp, np_) == (k, n)
    if m >= 128 * 7 * 7:
        tiles = -(-kp // ck._TC_ROWS) * (np_ // 64)
        assert splits * tiles >= 132, (shape, splits, tiles)


@pytest.mark.parametrize("k,n,fuse,stats,own", [
    (64, 256, False, False, (False, False)),   # x and dy read in place
    (64, 256, True, True, (True, True)),       # z normalised, dyl folded
    (1024, 256, False, True, (False, True)),   # s3_conv1: x in place
    (24, 72, False, False, (True, True)),      # ragged: both padded
    (64, 72, False, False, (False, True)),
])
def test_one_tap_scratch_reads_x_and_dy_in_place_where_it_can(k, n, fuse,
                                                              stats, own):
    assert ck.matmul_bwd_scratch(k, n, fuse, stats) == own
    # an input that does not start on 16 bytes gets its own copy
    assert ck.matmul_bwd_scratch(k, n, fuse, stats, False, False) == (
        True, True)


def _fold_model(x, w, vec, dy, gm, gs, y="rounded"):
    """A model of #9's tensor-core route with statistics: the y it folds,
    z.W with f32 sums rounded to bf16 as the forward stored it ("rounded",
    the saved y), or left unrounded, or K itself ("ignored": the saved y
    not read), folded into dyl = dy + gm + gs (y - K) cast to bf16, then
    dz = dyl.W^T, dW = z^T.dyl and dx; ``(dx, dw)``."""
    mean, scale, beta, kshift = vec
    z = ck._z(x, (mean, scale, beta)).float()
    yf = {"rounded": lambda: (z @ w.float()).to(torch.bfloat16).float(),
          "unrounded": lambda: z @ w.float(),
          "ignored": lambda: kshift.expand(x.shape[0], -1)}[y]()
    dyl = (dy.float() + gm + gs * (yf - kshift)).to(torch.bfloat16).float()
    dz = dyl @ w.float().t()
    dx = ck._input_side(x, dz, mean, scale, beta, True, (0,))[0]
    return dx, (z.t() @ dyl).to(w.dtype)


def _fold_case(m, k, n):
    """x, w, the vectors, dy, gm, gs at chip_smoke.conv_inputs' scales,
    and the plain version's dx and dW folding the forward's saved y."""
    rs = np.random.RandomState(5)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale)
    bf = torch.bfloat16
    x = (rnd(m, k, scale=1.5) + 0.3).to(bf)
    w = rnd(k, n, scale=(2.0 / k) ** 0.5).to(bf)
    vec = (rnd(k, scale=0.1), rnd(k).abs() + 0.5, rnd(k, scale=0.2),
           rnd(n, scale=0.05))
    dy, gm, gs = rnd(m, n).to(bf), rnd(n, scale=0.1), rnd(n, scale=0.1)
    y = ck.plain_matmul_bn_fwd(x, w, *vec, fuse_input=True,
                               emit_stats=True)[0]
    dx, dw, _, _ = ck.plain_matmul_bn_bwd(x, w, *vec, y, dy, gm, gs,
                                          fuse_input=True, emit_stats=True)
    return (x, w, vec, dy, gm, gs), (dx, dw)


@pytest.mark.parametrize("m,k,n", [(4096, 64, 256), (2048, 256, 64)])
def test_conv_rule_refuses_the_fold_of_an_unrounded_y(m, k, n):
    """conv_held passes #9's fold of the y the forward stored (rounded to
    bf16) and refuses a fold of y unrounded, where gs (y_r - y) moves a
    few percent of the folded dy to its other bf16 neighbour, at
    chip_smoke.conv_inputs' scales."""
    args, (dx, dw) = _fold_case(m, k, n)
    for got, want in zip(_fold_model(*args), (dx, dw)):
        assert chip_smoke.conv_held(got, want)[2]
    got_dx, got_dw = _fold_model(*args, y="unrounded")
    assert not chip_smoke.conv_held(got_dx, dx)[2]
    assert not chip_smoke.conv_held(got_dw, dw)[2]


@pytest.mark.parametrize("m,k,n", [(4096, 64, 256), (2048, 256, 64)])
def test_conv_rule_refuses_the_fold_with_the_saved_y_ignored(m, k, n):
    """A fold that reads y = K instead of the saved y (chip_gate_controls.py's
    saved_y_ignored_in_9: the gs term vanishes) is refused on dx and dW."""
    args, (dx, dw) = _fold_case(m, k, n)
    got_dx, got_dw = _fold_model(*args, y="ignored")
    assert not chip_smoke.conv_held(got_dx, dx)[2]
    assert not chip_smoke.conv_held(got_dw, dw)[2]


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_one_tap_fwd_scratch_within_budget(shape):
    """#8's tensor-core scratch as its wrapper allocates it: z [M, Kp] and
    the padded W [Kp, Np] in bf16 where they are stored, and the f32
    statistics partials of 128-row tiles, within the budget of the dW
    partials; at ResNet-50's widths W is read in place, and x too where
    there is no norm."""
    m, k, n = shape
    kp, np_ = ck.tc_channels(k), ck.tc_channels(n)
    for fuse in (False, True):
        own_z, own_w = ck.matmul_fwd_scratch(k, n, fuse)
        scratch = (m * kp * own_z + kp * np_ * own_w) * 2 \
            + 2 * -(-m // ck._TC_ROWS) * n * 4
        assert scratch <= ck._MAX_PART_BYTES
        if k % 64 == 0 and n % 64 == 0:
            assert (own_z, own_w) == (fuse, False)


@pytest.mark.parametrize("k,n,fuse,own", [
    (64, 256, False, (False, False)),    # s1_conv1's widths: all in place
    (64, 256, True, (True, False)),      # s1_conv3: z normalised
    (1024, 256, False, (False, False)),  # s3_conv1
    (24, 72, False, (True, True)),       # ragged: both padded
    (64, 72, False, (False, True)),
])
def test_one_tap_fwd_scratch_reads_x_and_w_in_place_where_it_can(k, n, fuse,
                                                                 own):
    assert ck.matmul_fwd_scratch(k, n, fuse) == own
    # an input that does not start on 16 bytes gets its own copy
    assert ck.matmul_fwd_scratch(k, n, fuse, False, False) == (True, True)


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
    """bf16 dQ runs on the tensor cores and takes dK/dV's rule: an entry
    one ulp off holds, as does every one of the 1% that may differ; f32
    keeps its tolerance for both."""
    want = _bf16_grid(4)
    got = want.clone()
    got.view(-1)[0] = _next_up(want.view(-1)[0])
    assert chip_smoke.bwd_held("dq", got, want)[2]
    got.view(-1)[:40] = _next_up(want.view(-1)[:40])     # 0.98% of them
    assert chip_smoke.bwd_held("dq", got, want)[2]
    f32 = want.float()
    for kernel in ("dq", "dkv"):
        assert chip_smoke.bwd_held(kernel, f32 * (1 + 1e-6), f32)[2]
        assert not chip_smoke.bwd_held(kernel, f32 * (1 + 1e-3), f32)[2]


def test_bwd_rule_refuses_many_dq_entries_one_ulp_off():
    """A truncated dS cast moves a large share of dQ's entries by about an
    ulp: the share refuses it, as the bound refuses one entry far off."""
    want = _bf16_grid(6)
    assert not chip_smoke.bwd_held("dq", _next_up(want), want)[2]
    got = want.clone()
    got.view(-1)[:60] = _next_up(want.view(-1)[:60])     # 1.5%
    assert not chip_smoke.bwd_held("dq", got, want)[2]
    got = want.clone()
    top = float(want.float().abs().max())
    got.view(-1)[3] = (want.view(-1)[3].float()
                       + 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
                       ).to(torch.bfloat16)
    assert not chip_smoke.bwd_held("dq", got, want)[2]


@pytest.mark.parametrize("shape,rows,held", [
    ((3, 2, 5, 8), 6, True),       # Tq 5: one query row a head
    ((3, 2, 5, 8), 7, False),
    ((1, 2, 4, 8), 2, True),       # Tq 4: one query row a head
    ((1, 2, 4, 8), 3, False),
    ((1, 1, 200, 8), 2, True),     # Tq 200: 1% (16 entries) still rules
    ((1, 1, 200, 8), 3, False),
])
def test_bwd_rule_takes_one_query_row_a_head_where_tq_is_short(shape, rows,
                                                               held):
    """dQ's share counts query rows: one dS on its other bf16 neighbour
    moves a row of D entries, so where Tq < 100 the share is one such row
    of each head (1/Tq of the entries)."""
    want = _bf16_grid(8, shape)
    got = want.clone()
    flat_rows = got.view(-1, shape[-1])
    flat_rows[:rows] = _next_up(want.view(-1, shape[-1])[:rows])
    assert chip_smoke.bwd_held("dq", got, want)[2] is held


def _dq_with_ds(args, cfg, cast, dtype=torch.float32):
    """#2's plain arithmetic with dS cast by ``cast`` before dS.K, the sum
    taken in ``dtype`` and rounded to f32."""
    q, k = args[0], args[1]
    _, ds = ak._p_and_ds(*args, cfg["scale"], cfg["causal"],
                         cfg["causal_offset"])
    dq = torch.matmul(cast(ds).to(dtype), k.to(dtype)).float()
    return (dq * cfg["scale"]).to(q.dtype)


@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 64),
                                   (2, 2, 100, 300, 32)])
def test_bwd_rule_refuses_dq_with_ds_truncated(shape):
    """dS cut to its top 16 bits before dS.K (chip_gate_controls.py's
    no_ds_cast_in_dq) moves more than 1% of dQ's entries: refused, where
    dS rounded to nearest, summed in another order, holds."""
    b, h, tq, tk, d = shape
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(torch.bfloat16)
               for t in (tq, tk, tk))
    cfg = dict(scale=d ** -0.5, causal=True, causal_offset=tk - tq)
    out, lse = ak.plain_attention_fwd(q, k, v, None, **cfg)
    do = torch.randn(out.shape, generator=g).to(torch.bfloat16)
    args = (q, k, v, None, do, lse, ak.attention_delta(out, do))
    want = ak.plain_attention_dq(*args, **cfg)
    floor = chip_smoke.bwd_floors(*args, **cfg)[0]
    # dS rounded as the kernel rounds it, dS.K summed in f64 then f32
    rounded = _dq_with_ds(args, cfg, lambda x: x.to(torch.bfloat16),
                          torch.float64)
    assert chip_smoke.bwd_held("dq", rounded, want, floor)[2]
    truncated = _dq_with_ds(args, cfg, _truncated)
    err, differ, ok = chip_smoke.bwd_held("dq", truncated, want, floor)
    assert not ok and differ > 0.01 * want.numel()


# ---- chip_smoke's rule for #5's bf16 state -----------------------------------

def _truncated(p):
    """P cut to its top 16 bits: a bf16 cast without its rounding."""
    return (p.float().contiguous().view(torch.int32) & ~0xffff) \
        .view(torch.float32)


def _tiled_merge(q, k, v, acc, m, l, cast, *, q_offset, k_offset, scale,
                 causal, tile=64, bias=None):
    """A model of the tensor-core merge's arithmetic: the online softmax
    over 64-key tiles, P cast by ``cast`` before P.V, l from the
    unrounded P; ``bias`` (#1's) added to the scaled scores."""
    if causal and q_offset + q.shape[-2] - 1 < k_offset:
        return acc, m, l
    s_all = ak._partial_scores(q, k, scale, causal, q_offset, k_offset)
    if bias is not None:
        s_all = s_all + bias.float()
    for k0 in range(0, k.shape[-2], tile):
        s = s_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            cast(p), v[..., k0:k0 + tile, :].float())
        m = m_new
    return acc, m, l


# chip_smoke's four chunk pairs at two heads (tq, tk, d, q_offset,
# k_offset, causal, state carried), and a pair whose first 100 rows see
# no key
PARTIAL_PAIRS = [(512, 512, 64, 1024, 1024, True, False),
                 (512, 512, 64, 1536, 512, True, True),
                 (512, 512, 64, 512, 1536, False, True),
                 (200, 200, 40, 200, 0, True, True),
                 (256, 256, 64, 0, 100, True, False)]


def _state_pair(pair, cast):
    """(the model's acc / l, the plain version's) for one chunk pair."""
    tq, tk, d, q_off, k_off, causal, carried = pair
    g = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)
    q, k, v = rnd(1, 2, tq, d), rnd(1, 2, tk, d), rnd(1, 2, tk, d)
    cfg = dict(q_offset=q_off, scale=d ** -0.5, causal=causal)
    state = (torch.zeros(1, 2, tq, d), torch.full((1, 2, tq), ak.NEG_INF),
             torch.zeros(1, 2, tq))
    if carried:
        state = ak.plain_attention_partial(q, rnd(1, 2, tq, d),
                                           rnd(1, 2, tq, d), *state,
                                           k_offset=q_off, **cfg)
    got = _tiled_merge(q, k, v, *state, cast, k_offset=k_off, **cfg)
    want = ak.plain_attention_partial(q, k, v, *state, k_offset=k_off, **cfg)
    return got[0] / got[2][..., None], want[0] / want[2][..., None]


@pytest.mark.parametrize("pair", PARTIAL_PAIRS)
def test_partial_rule_passes_the_tiled_merge_rounded_to_nearest(pair):
    got, want = _state_pair(pair, lambda p: p.to(torch.bfloat16).float())
    assert chip_smoke.partial_state_held(got, want, torch.bfloat16)[2]
    assert abs(chip_smoke.state_bias(got, want)) < \
        chip_smoke.PARTIAL_BF16_BIAS / 20


@pytest.mark.parametrize("pair", PARTIAL_PAIRS)
def test_partial_rule_refuses_p_truncated(pair):
    """P cut short instead of rounded stays within BF16_TOL everywhere,
    but its bias is several times the rule's bound."""
    got, want = _state_pair(pair, _truncated)
    assert torch.allclose(got, want, **chip_smoke.BF16_TOL)
    assert not chip_smoke.partial_state_held(got, want, torch.bfloat16)[2]
    assert chip_smoke.state_bias(got, want) < \
        -3 * chip_smoke.PARTIAL_BF16_BIAS


def test_partial_rule_keeps_f32_at_its_tolerance():
    want = torch.randn(2, 4, 8, 16, generator=torch.Generator()
                       .manual_seed(0))
    assert chip_smoke.partial_state_held(want * (1 + 1e-6), want,
                                         torch.float32)[2]
    assert not chip_smoke.partial_state_held(want * (1 + 1e-3), want,
                                             torch.float32)[2]


# ---- #1's tiled forward, held by the bias rule -----------------------------

def _tiled_forward(q, k, v, bias, cast, *, causal, causal_offset):
    """A model of #1's tensor-core route: _tiled_merge from the fresh state
    (acc 0, m -inf, l 0) over 64-key tiles, then the epilogue out = acc / l
    rounded to q's dtype."""
    b, h, tq, d = q.shape
    state = (torch.zeros(b, h, tq, d), torch.full((b, h, tq), -math.inf),
             torch.zeros(b, h, tq))
    acc, _, l = _tiled_merge(q, k, v, *state, cast, q_offset=causal_offset,
                             k_offset=0, scale=d ** -0.5, causal=causal,
                             bias=bias)
    return (acc / l[..., None]).to(q.dtype)


def _padded_lm_bias(t, lengths):
    """The padded LM's bias (models/transformer_lm.py): causal plus -1e9 on
    the padding keys of each row, [B, 1, T, T]."""
    from bigdl_tpu_torch.nn.attention import causal_bias, padding_bias
    tokens = torch.ones(len(lengths), t, dtype=torch.long)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0
    return causal_bias(t) + padding_bias(tokens)


# (b, h, tq, tk, d, causal, bias lengths): chip_smoke's training shape cut
# in length, its ragged bf16 row, rows that see no key, the padded LM;
# each with at least chip_smoke.FWD_BIAS_ROWS rows that see a key
FWD_CASES = [(2, 8, 256, 256, 64, True, None),
             (4, 16, 100, 300, 40, True, None),
             (8, 8, 300, 100, 32, True, None),
             (2, 8, 256, 256, 64, False, (200, 17))]


def _fwd_pair(case, cast):
    """(the model's bf16 output, plain_attention's, the rows that see a
    key) for one case."""
    b, h, tq, tk, d, causal, lengths = case
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(torch.bfloat16)
               for t in (tq, tk, tk))
    bias = None if lengths is None else _padded_lm_bias(tk, lengths)
    got = _tiled_forward(q, k, v, bias, cast, causal=causal,
                         causal_offset=tk - tq)
    return (got, ak.plain_attention(q, k, v, bias, causal=causal),
            chip_smoke.seen_rows(tq, tk, causal))


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_rule_passes_the_tiled_forward_rounded_to_nearest(case):
    got, want, seen = _fwd_pair(case, lambda p: p.to(torch.bfloat16).float())
    assert chip_smoke.fwd_held(got, want, seen)[2]
    assert abs(chip_smoke.seen_bias(got, want, seen)[0]) < \
        chip_smoke.PARTIAL_BF16_BIAS / 4


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_rule_refuses_p_truncated(case):
    """P cut short stays within BF16_TOL, but the error's bias is several
    times the rule's bound."""
    got, want, seen = _fwd_pair(case, _truncated)
    assert torch.allclose(got.float(), want.float(), **chip_smoke.BF16_TOL)
    assert not chip_smoke.fwd_held(got, want, seen)[2]
    assert chip_smoke.seen_bias(got, want, seen)[0] < \
        -3 * chip_smoke.PARTIAL_BF16_BIAS


def test_fwd_rule_reads_no_bias_below_its_rows():
    """At the 128 rows of a pooled decode the bias of rounding noise
    reaches the bound, so there BF16_TOL holds alone; rows that see no key
    are left out of the count and the bias."""
    want = torch.randn(16, 8, 1, 64, generator=torch.Generator()
                       .manual_seed(3)).to(torch.bfloat16)
    off = (want.float() * (1 - 2.0 ** -8)).to(torch.bfloat16)
    assert chip_smoke.fwd_held(off, want)[2]
    wide = want.expand(16, 8, 32, 64)
    assert not chip_smoke.fwd_held(
        (wide.float() * (1 - 2.0 ** -8)).to(torch.bfloat16), wide)[2]
    seen = chip_smoke.seen_rows(32, 8, True)
    assert int(seen.sum()) == 8
    assert chip_smoke.fwd_held(
        (wide.float() * (1 - 2.0 ** -8)).to(torch.bfloat16), wide, seen)[2]


# ---- #7's split-bf16 route, held by the dK and dV rules --------------------

def _split3(x):
    """f32 x as three bf16 pieces (kept in f32): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    return hi, mid, (rest - mid).to(torch.bfloat16).float()


# The three pieces sum to x exactly from 2^-110 (7.7e-34: below it the last
# piece falls under bf16's smallest subnormal step, 2^-133) up to bf16's
# largest finite value (3.3895e38: above it hi rounds to inf).  dO and P
# (at most 1; an exp(s - lse) under 2^-110 weighs nothing) stay inside.
@settings(max_examples=400, deadline=None)
@given(st.floats(min_value=float(np.float32(1e-30)),
                 max_value=float(np.float32(3.38e38)), width=32),
       st.booleans())
def test_three_bf16_pieces_sum_to_the_f32_value_exactly(x, negative):
    t = torch.tensor([-x if negative else x], dtype=torch.float32)
    pieces = _split3(t)
    assert all(bool((p.to(torch.bfloat16).float() == p).all())
               for p in pieces)
    assert float(sum(p.double() for p in pieces)) == float(t.double())


def test_three_bf16_pieces_stop_being_exact_below_two_to_the_minus_110():
    for e, exact in ((-110, True), (-111, False)):
        t = torch.tensor([2.0 ** e * (1 + 2 ** -22 + 2 ** -23)])
        got = float(sum(p.double() for p in _split3(t)))
        assert (got == float(t.double())) is exact, e


def _dkv_partial_model(q, k, v, do, lse, delta, *, q_offset, k_offset,
                       scale, causal, do_pieces=3):
    """A model of #7's tensor-core route: bf16 pieces, f32 sums, 32-query
    tiles (every key row of a 64-key block is summed on its own, so the
    key tiling changes no sum).  dP over dO's pieces smallest first; dV
    per 16-query step over the six terms of P's and dO's pieces down to
    2^-24, smallest first, into a fresh sum added to the running one; dK
    from dS rounded to bf16.  ``do_pieces=1`` rounds dO to bf16 instead."""
    b, h, tq, d = q.shape
    s = ak._partial_scores(q, k, scale, causal, q_offset, k_offset)
    dop = _split3(do)[:do_pieces]
    vf = v.float()
    dp = sum(torch.matmul(x, vf.transpose(-1, -2)) for x in dop[::-1])
    p = torch.exp(s - lse[..., None])
    ds = p * (dp - delta[..., None])
    if causal:
        rows = q_offset + torch.arange(tq)
        keys = k_offset + torch.arange(k.shape[-2])
        ds = ds.masked_fill(rows[:, None] < keys[None, :], 0.0)
    pp = _split3(p)
    terms = [(i, j) for i in range(3) for j in range(len(dop)) if i + j <= 2]
    terms.sort(key=lambda t: -(t[0] + t[1]))     # smallest first
    dk = torch.zeros(b, h, k.shape[-2], d)
    dv = torch.zeros(b, h, k.shape[-2], d)
    dsq = ds.to(torch.bfloat16).float()
    for i0 in range(0, tq, 16):
        rows = slice(i0, i0 + 16)
        fresh = torch.zeros_like(dv)
        for i, j in terms:
            fresh = fresh + torch.matmul(pp[i][..., rows, :].transpose(-1, -2),
                                         dop[j][..., rows, :])
        dv = dv + fresh
        dk = dk + torch.matmul(dsq[..., rows, :].transpose(-1, -2),
                               q[..., rows, :].float())
    return dk * scale, dv


def _ring_lse_delta(q, v, tdt, q_off, causal, tc, d):
    """A finite whole-sequence lse and Δ for the rows of q: the diagonal
    chunk's own logsumexp plus log 2 (as if other chunks weighed as much),
    Δ small and random (tests/test_torch_ring_attention.py's)."""
    acc = torch.zeros(1, 2, tc, d)
    m = torch.full((1, 2, tc), ak.NEG_INF)
    _, m, l = ak.plain_attention_partial(
        q.to(tdt), q.to(tdt), v.to(tdt), acc, m, torch.zeros(1, 2, tc),
        q_offset=q_off, k_offset=q_off, scale=d ** -0.5, causal=causal)
    lse = m + torch.log(torch.where(l == 0, 1.0, l)) + float(np.log(2.0))
    delta = torch.from_numpy(np.random.RandomState(9).randn(1, 2, tc)
                             .astype(np.float32) * 0.1)
    return lse, delta


# the ring tests' B1 H2 Tc16 D8 pairs (name, q_offset, k_offset, causal),
# then an off-diagonal D64 pair at Tc128 (four 32-query tiles)
DKV_PAIRS = [("diagonal", 16, 16, True, 16, 8),
             ("off_diagonal", 32, 0, True, 16, 8),
             ("non_causal", 16, 48, False, 16, 8),
             ("off_diagonal_d64", 256, 128, True, 128, 64)]


def _dkv_inputs(pair):
    _, q_off, k_off, causal, tc, d = pair
    rs = [np.random.RandomState(s) for s in (11, 12, 13, 14)]
    q, k, v, do = (torch.from_numpy(r.randn(1, 2, tc, d).astype(np.float32))
                   for r in rs)
    bf = torch.bfloat16
    lse, delta = _ring_lse_delta(q, v, bf, q_off, causal, tc, d)
    cfg = dict(q_offset=q_off, k_offset=k_off, scale=d ** -0.5,
               causal=causal)
    return (q.to(bf), k.to(bf), v.to(bf), do, lse, delta), cfg


def _pallas_dkv_partial(args, cfg):
    """The reference's Pallas #7 in interpret mode on the same inputs."""
    import jax.numpy as jnp
    from bigdl_tpu.ops import attention_kernels as jak
    q, k, v, do, lse, delta = args
    j = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in args]
    dk, dv = jak.flash_attention_dkv_partial(
        *j, q_offset=cfg["q_offset"], k_offset=cfg["k_offset"],
        causal=cfg["causal"], scale=cfg["scale"], block_q=None,
        block_k=None, interpret=True)
    return tuple(torch.from_numpy(np.array(x, dtype=np.float32))
                 for x in (dk, dv))


@pytest.mark.parametrize("pair", DKV_PAIRS, ids=[p[0] for p in DKV_PAIRS])
def test_dkv_partial_rule_passes_the_split_model_refuses_one_piece(pair):
    """#7's split route (modelled) holds against the plain version and
    against the Pallas kernel in interpret mode by chip_smoke's rule: dK
    within one bf16 ulp, at most max(1%, 1/Tk) differing in bf16, dV
    within 4x the reference's own error against an f64 sum.  The same
    model with dO rounded to bf16 (what a bf16 tensor-core backward
    computes) is refused: its dV error is about 2^-9."""
    args, cfg = _dkv_inputs(pair)
    exact = chip_smoke.dkv_partial_exact_dv(*args, **cfg)
    got = _dkv_partial_model(*args, **cfg)
    one_piece = _dkv_partial_model(*args, **cfg, do_pieces=1)
    for want in (ak.plain_attention_dkv_partial(*args, **cfg),
                 _pallas_dkv_partial(args, cfg)):
        checks, readings = chip_smoke.dkv_partial_held(got, want, exact)
        assert all(ok for _, _, ok in checks), (checks, readings)
        checks, readings = chip_smoke.dkv_partial_held(one_piece, want,
                                                       exact)
        assert not checks[1][2], readings
        assert readings["dv_err"] > 100 * readings["dv_plain_err"]


# ---- #6's split-bf16 route, held by the shared ulp rule --------------------

def _dq_partial_model(q, k, v, do, lse, delta, *, q_offset, k_offset, scale,
                      causal, do_pieces=3, cast=None):
    """A model of #6's tensor-core route: bf16 pieces, f32 sums, 32-key
    tiles.  dP over dO's pieces smallest first, each 16-deep step of the
    head dim into a fresh sum added to the running one; dS cast by
    ``cast`` (to bf16, to nearest, by default) before dQ = scale * sum of
    dS . K over the key tiles.  ``do_pieces=1`` rounds dO to bf16 instead
    (what a bf16 tensor-core backward computes)."""
    s = ak._partial_scores(q, k, scale, causal, q_offset, k_offset)
    dop = _split3(do)[:do_pieces]
    vf = v.float()
    dp = torch.zeros_like(s)
    for c0 in range(0, q.shape[-1], 16):
        dp = dp + sum(torch.matmul(x[..., c0:c0 + 16],
                                   vf[..., c0:c0 + 16].transpose(-1, -2))
                      for x in dop[::-1])
    ds = torch.exp(s - lse[..., None]) * (dp - delta[..., None])
    if causal:
        rows = q_offset + torch.arange(q.shape[-2])
        keys = k_offset + torch.arange(k.shape[-2])
        ds = ds.masked_fill(rows[:, None] < keys[None, :], 0.0)
    dsq = ds.to(torch.bfloat16).float() if cast is None else cast(ds)
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], 32):
        dq = dq + torch.matmul(dsq[..., k0:k0 + 32],
                               k[..., k0:k0 + 32, :].float())
    return dq * scale


def _pallas_dq_partial(args, cfg):
    """The reference's Pallas #6 in interpret mode on the same inputs."""
    import jax.numpy as jnp
    from bigdl_tpu.ops import attention_kernels as jak
    j = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in args]
    dq = jak.flash_attention_dq_partial(
        *j, q_offset=cfg["q_offset"], k_offset=cfg["k_offset"],
        causal=cfg["causal"], scale=cfg["scale"], block_q=None,
        block_k=None, interpret=True)
    return torch.from_numpy(np.array(dq, dtype=np.float32))


@pytest.mark.parametrize("pair", DKV_PAIRS, ids=[p[0] for p in DKV_PAIRS])
def test_dq_partial_rule_passes_the_split_model_refuses_one_piece(pair):
    """#6's split route (modelled) holds against the plain version and
    against the Pallas kernel in interpret mode by chip_smoke's rule
    (partial_ulp_held: each entry within one bf16 ulp of the plain entry
    or of the largest, at most max(1%, one row a head) differing in
    bf16).  The same model with dO rounded to bf16 (chip_gate_controls.py's
    no_do_split_in_6) or dS truncated (no_ds_cast_in_6) moves far more
    than 1% of the entries: refused, with no f64 anchor needed."""
    args, cfg = _dkv_inputs(pair)
    got = _dq_partial_model(*args, **cfg)
    one_piece = _dq_partial_model(*args, **cfg, do_pieces=1)
    truncated = _dq_partial_model(*args, **cfg, cast=_truncated)
    for want in (ak.plain_attention_dq_partial(*args, **cfg),
                 _pallas_dq_partial(args, cfg)):
        assert chip_smoke.partial_ulp_held(got, want)[2]
        for bad in (one_piece, truncated):
            _, differ, ok = chip_smoke.partial_ulp_held(bad, want)
            assert not ok and differ > 0.3 * want.numel()


def test_partial_ulp_rule_counts_a_row_a_head_where_rows_are_few():
    """partial_ulp_held's share: 1% of the entries, or one row of D entries
    a head where there are fewer than 100 rows; the f32 entries count once
    rounded to bf16, so a move below bf16's granularity is no difference."""
    want = _bf16_grid(9, (1, 2, 4, 8)).float()
    got = want.clone()
    got[:, :, 0] = _next_up(want[:, :, 0].to(torch.bfloat16)).float()
    assert chip_smoke.partial_ulp_held(got, want)[1:] == (16, True)
    got[:, 0, 1] = _next_up(want[:, 0, 1].to(torch.bfloat16)).float()
    assert not chip_smoke.partial_ulp_held(got, want)[2]
    tiny = want * (1 + 2.0 ** -20)
    assert chip_smoke.partial_ulp_held(tiny, want)[1:] == (0, True)


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
