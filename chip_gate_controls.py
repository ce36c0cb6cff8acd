#!/usr/bin/env python3
"""Show, on one NVIDIA GPU, that chip_smoke.py's backward checks refuse
the faults they are there to catch:

    python3 chip_gate_controls.py        # from the repository root

1. Kernel mutants.  ``flash_attention_bwd.cu`` is rebuilt, into the
   git-ignored build directory, with one of the reference's bf16 rounding
   points taken out: dS before dS·K (dQ), dS before dSᵀ·Q (dK), P before
   Pᵀ·dO (dV).  dQ and dK/dV in bf16 run on the tensor cores, where P and
   dS reach the product as bf16 operands: there the fault packs each f32
   value's top 16 bits, the cast's rounding dropped.
   Each mutant runs through the port's own wrappers at chip_smoke's
   training shape (t), and its outputs go through chip_smoke's check
   against the plain versions (``bwd_held``).  The script
   fails unless that check passes the source as it stands and refuses
   every mutant.  Beside each output it prints how many entries moved,
   the largest move in ulps of the largest entry, and whether a
   tolerance of 2e-2 of the largest entry would have seen it.
2. A control training step.  chip_smoke's f32 step (the full-width LM at
   batch 2, card against a CPU copy) runs as it is and again with the
   attention backward in bf16: q, k, v and dO rounded to bf16 before the
   dQ and dK/dV kernels.  The script fails unless the first stays within
   chip_smoke's bounds and the second does not.
3. Conv+BN mutants.  ``conv_bn_fwd.cu`` or ``conv_bn_bwd.cu`` is rebuilt
   with one fault: in #8's tensor-core route z stored cut to bf16 instead
   of rounded (the prepass's cast dropped) or y stored cut to bf16 (the
   one-tap epilogue's cast dropped), in its f32 route z cast to bf16
   (where the cast to x's dtype, f32, is the identity); in #10's scalar
   route (f32) the 3x3's halo zeroed before normalize+ReLU (the border
   then reads relu(beta - mean * scale)); in #10's tensor-core route z
   stored cut to bf16 and the halo of a shifted row copied from the
   position's own row instead of zero-filled; in #9's tensor-core route
   the fold blind to the forward's saved y (y = K, so the gs term
   vanishes), or the folded dy stored cut to bf16 instead of rounded;
   and in #11's tensor-core route the folded dy stored cut to bf16 and
   the halo copied.  Faults in a line two kernels share (the prepass's z
   and dyl casts, the halo, the epilogue's y cast) are each built into
   the library of the kernel whose check must refuse them.  Each runs
   through chip_smoke's conv check at a ResNet-50 b128 shape in bf16 (the
   f32 faults at a ragged f32 shape); the script fails unless the check
   passes the sources as they stand and refuses every mutant, and prints
   the share of entries each fault moves.
4. Ring-attention mutants.  ``flash_attention_fwd.cu`` is rebuilt with
   #5's causal test on local rather than global positions (the offset
   q_offset - k_offset taken as 0, which both of #5's routes read), or
   with P packed by truncation in #5's tensor-core route (the top 16 bits
   of each f32 value, the cast's rounding dropped), and
   ``flash_attention_bwd.cu`` with #7's P cast to q's dtype before Pᵀ·dO
   (the rule of #3, where dO is in q's dtype; the ring's dO is f32): in
   #7's tensor-core route P's mid and lo pieces dropped; or with dO's mid
   and lo pieces dropped in the split #6 and #7 share (dO rounded to
   bf16, what a bf16 tensor-core backward such as SDPA's computes), built
   once for each kernel's check; or with #6's dS packed by truncation (the
   line #6 shares with #2).  Each runs through chip_smoke's check of
   #5-#7 at the SP path's off-diagonal bf16 chunk pair; the script fails
   unless the check passes the sources as they stand and refuses each
   mutant, and prints the share of entries each moves from the plain
   version and from the source as it stands (and #5's state bias, #7's dV
   errors against the f64 sum).
4b. A forward mutant.  ``flash_attention_fwd.cu`` with P packed by
   truncation in the tensor-core loop #1 shares with #5, through #1's
   wrapper at chip_smoke's LM training shape, held by its check
   (``fwd_held``: the bias of the error refuses it).
4c. Design variants, timed against the sources as they stand on the same
   inputs (a reading, not a gate): #1's query blocks in grid order
   instead of heaviest first, #7's dV over its three largest terms
   alone, and #2's K/V tiles of 64 keys at D64, with whether chip_smoke's
   check passes each.
5. A control ResNet-50 step.  chip_smoke's f32 fused step (batch 4,
   64 px, card against a CPU copy) runs as it is and again with the conv
   kernels fed x and W rounded to bf16; the script fails unless the first
   stays within chip_smoke's bounds and the second does not.  Beside
   them it prints how far three CPU steps whose inputs moved by 2^-23 of
   themselves drift from the CPU step: the noise floor a ReLU flipped by
   rounding sets under the bounds.

The last line is one JSON object with every reading.  Imports torch,
numpy, ``bigdl_tpu_torch`` and ``chip_smoke`` only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke

# name: (the line as it stands, the line without the cast, the output).
# #2's and #3's bf16 routes run on the tensor cores, where P and dS reach
# the product as bf16 operands packed from f32: the cast is the packing's
# rounding, and the fault packs the top 16 bits of each f32 value (the
# cast's rounding dropped)
MUTANTS = {
    "no_ds_cast_in_dq": (
        "dsa[j][hh] = tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);",
        "dsa[j][hh] = (__float_as_uint(dp[j][2 * hh]) >> 16) | "
        "(__float_as_uint(dp[j][2 * hh + 1]) & 0xffff0000u);", "dq"),
    "no_ds_cast_in_dk": (
        "df[j][hh] = tc::pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);",
        "df[j][hh] = (__float_as_uint(dp[j][2 * hh]) >> 16) | "
        "(__float_as_uint(dp[j][2 * hh + 1]) & 0xffff0000u);", "dk"),
    "no_p_cast_in_dv": (
        "pf[j][hh] = tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);",
        "pf[j][hh] = (__float_as_uint(s[j][2 * hh]) >> 16) | "
        "(__float_as_uint(s[j][2 * hh + 1]) & 0xffff0000u);", "dv"),
}
LOOSE_REL = 2e-2   # a tolerance relative to the largest entry
BWD_ENTRIES = ("flash_attention_dq", "flash_attention_dkv")

# name: (the file with the fault, the library built from it, the line as
# it stands, the line with the fault, chip_smoke's conv problem, the
# output whose check must refuse it)
CONV_MUTANTS = {
    # #8's tensor-core route stores z in the prepass it shares with #10:
    # the fault stores the unrounded normalize+ReLU cut to its top 16 bits
    "no_z_cast_in_8": (
        "conv_bn_tc.cuh", "conv_bn_fwd",
        "return from_f32<bf16>(fuse ? norm_relu<bf16>(x, mean, scale, beta) "
        ": x);",
        "return __float2bfloat16_rz(fuse ? fmaxf(bn_input(x, mean, scale, "
        "beta), 0.f) : x);", "s1_conv3", ("y",)),
    # #8's scalar route runs in f32 only, where z's cast to x's dtype is
    # the identity (dropping it changes no bit): the fault casts z to bf16
    # instead, the rounding point of the bf16 route taken at the wrong type
    "z_cast_to_bf16_in_8_f32": (
        "conv_bn_fwd.cu", "conv_bn_fwd",
        "return fuse ? norm_relu<T>(xv, mean[k], scale[k], beta[k]) : xv;",
        "return fuse ? norm_relu<__nv_bfloat16>(xv, mean[k], scale[k], "
        "beta[k]) : xv;", "r1_f32_norm", ("y",)),
    # the one-tap (and #10's) epilogue stores y cut to its top 16 bits
    "no_y_cast_in_8": (
        "conv_bn_tc.cuh", "conv_bn_fwd",
        "const __nv_bfloat162 y2 = __floats2bfloat162_rn(y0, y1);",
        "const __nv_bfloat162 y2 = __halves2bfloat162("
        "__float2bfloat16_rz(y0), __float2bfloat16_rz(y1));",
        "s1_conv3", ("y",)),
    # #10's scalar route runs in f32 only: a ragged f32 problem
    "halo_zeroed_before_norm_in_10": (
        "conv_bn_fwd.cu", "conv_bn_fwd",
        "return pos >= 0 ? zv : 0.f;", "return zv;", "r3_f32_norm", ("y",)),
    # #10's tensor-core route stores z as a bf16 operand: the fault stores
    # the unrounded normalize+ReLU cut to its top 16 bits (the cast dropped)
    "no_z_cast_in_10_prepass": (
        "conv_bn_tc.cuh", "conv_bn_fwd",
        "return from_f32<bf16>(fuse ? norm_relu<bf16>(x, mean, scale, beta) "
        ": x);",
        "return __float2bfloat16_rz(fuse ? fmaxf(bn_input(x, mean, scale, "
        "beta), 0.f) : x);", "s1_conv2", ("y",)),
    # the halo of a shifted row of z copied (the position's own row)
    # instead of zero-filled: the line #11 shares, built into #10's library
    "halo_copied_in_10": (
        "conv_bn_tc.cuh", "conv_bn_fwd",
        "tc::cp_async16(dst, base + (halo ? own : pos) * ld + c, !halo);",
        "tc::cp_async16(dst, base + (halo ? own : pos) * ld + c, true);",
        "s1_conv2", ("y",)),
    # #9's tensor-core route folds the forward's saved y into dyl in the
    # prepass it shares with #11: the faults fold y = K (the saved y
    # ignored: the gs term vanishes), or store the fold cut to its top 16
    # bits (the dyl cast dropped; #11's control edits the same line)
    "saved_y_ignored_in_9": (
        "conv_bn_tc.cuh", "conv_bn_bwd",
        "p.stats ? yv[j] : 0.f, gm[j],",
        "p.stats ? kshift[j] : 0.f, gm[j],",
        "s1_conv3", ("dx", "dw")),
    "no_dyl_cast_in_9": (
        "conv_bn_tc.cuh", "conv_bn_bwd",
        "return from_f32<bf16>(fold_dy<bf16>(dy, y, gm, gs, k, stats));",
        "return __float2bfloat16_rz(fold_dy<float>(dy, y, gm, gs, k, "
        "stats));", "s1_conv3", ("dx", "dw")),
    # #11's tensor-core route stores dyl as a bf16 operand: the fault
    # stores the unrounded fold cut to its top 16 bits (the cast dropped)
    "no_dyl_cast_in_11_prepass": (
        "conv_bn_tc.cuh", "conv_bn_bwd",
        "return from_f32<bf16>(fold_dy<bf16>(dy, y, gm, gs, k, stats));",
        "return __float2bfloat16_rz(fold_dy<float>(dy, y, gm, gs, k, "
        "stats));", "s1_conv2", ("dx", "dw")),
    # the halo of a shifted row copied (the position's own row) instead
    # of zero-filled
    "halo_copied_in_11": (
        "conv_bn_tc.cuh", "conv_bn_bwd",
        "tc::cp_async16(dst, base + (halo ? own : pos) * ld + c, !halo);",
        "tc::cp_async16(dst, base + (halo ? own : pos) * ld + c, true);",
        "s1_conv2", ("dx", "dw")),
}


# split_rows (#6 and #7) splits dO into bf16 pieces; the fault keeps hi
DO_SPLIT = ("const float2 do_rest = {a - __low2float(hi2), "
            "c - __high2float(hi2)};")
NO_DO_SPLIT = "const float2 do_rest = {0.f, 0.f};"
# #1's and #5's tensor-core loop packs P to bf16 from f32 fragments; the
# fault keeps each value's top 16 bits
PACK_P = "pf[j][hh] = tc::pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);"
TRUNCATE_P = ("pf[j][hh] = (__float_as_uint(s[j][2 * hh]) >> 16) | "
              "(__float_as_uint(s[j][2 * hh + 1]) & 0xffff0000u);")
# name: (the source with the fault, the line as it stands, the line with
# the fault, the partial kernel whose check must refuse it)
RING_MUTANTS = {
    "local_mask_in_5": (
        "flash_attention_fwd", "p.causal_offset = q_offset - k_offset;",
        "p.causal_offset = 0;", "partial"),
    # #5's bf16 route packs P from f32 fragments: the fault packs the top
    # 16 bits of each value (the cast's rounding dropped).  The line is the
    # forward loop's that #1 shares (FWD_MUTANTS)
    "p_truncated_in_5": (
        "flash_attention_fwd", PACK_P, TRUNCATE_P, "partial"),
    # #7's bf16 route splits P into three bf16 pieces: without its mid and
    # lo pieces P reaches Pᵀ·dO in bf16, q's dtype, where the reference
    # keeps it in dO's (f32)
    "p_cast_to_q_dtype_in_7": (
        "flash_attention_bwd",
        "const float2 p_rest = {a - __low2float(hi2), c - __high2float(hi2)};",
        "const float2 p_rest = {0.f, 0.f};", "dkv_partial"),
    # without dO's mid and lo pieces dP and dV see dO rounded to bf16: what
    # a bf16 tensor-core backward (SDPA's) computes
    "no_do_split_in_7": (
        "flash_attention_bwd", DO_SPLIT, NO_DO_SPLIT, "dkv_partial"),
    # the same line of split_rows, which #6 calls too: dP sees dO in bf16
    "no_do_split_in_6": (
        "flash_attention_bwd", DO_SPLIT, NO_DO_SPLIT, "dq_partial"),
    # dS packed by truncation before dS.K, in the loop #6 shares with #2
    "no_ds_cast_in_6": (
        "flash_attention_bwd", *MUTANTS["no_ds_cast_in_dq"][:2],
        "dq_partial"),
}
RING_PROBLEM = "offdiag_bf16"     # chip_smoke's B8 H8 Tc512 D64 bf16 pair
DQ_PROBLEM = "t_train"            # chip_smoke's B8 H8 T2048 D64 bf16 causal

# name: (the line as it stands, the line with the fault) in
# flash_attention_fwd.cu, held by chip_smoke's #1 check at FWD_PROBLEM
FWD_MUTANTS = {"p_truncated_in_1": (PACK_P, TRUNCATE_P)}
FWD_PROBLEM = "f_train"           # chip_smoke's B8 H8 T2048 D64 bf16 causal

# design variants timed against the sources as they stand: name: (library,
# [(the text as it stands, the variant's)], the kernel, chip_smoke's
# problem).  #1's query blocks in grid order instead of heaviest first;
# #1's (and #5's) blocks of 128 query rows on 8 warps, which halves the
# K/V tiles read from shared memory per product; P by expf, or by exp2f in
# log2 units; #7's dV over its three largest terms (hi.hi, hi.mid,
# mid.hi) alone; #2's K/V tiles of 64 keys at D64 instead of 32
VARIANTS = {
    "fwd_blocks_in_grid_order": (
        "flash_attention_fwd",
        [("const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;",
          "const int q0 = blockIdx.y * kTcRows;")], "fwd", FWD_PROBLEM),
    "fwd_128_rows_on_8_warps": (
        "flash_attention_fwd",
        [("constexpr int kTcWarps = 4;", "constexpr int kTcWarps = 8;")],
        "fwd", FWD_PROBLEM),
    # P = expf(s - m) as #1 and #5 had it before exp2f
    "fwd_expf": (
        "flash_attention_fwd",
        [("alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);",
          "alpha[hh] = expf(m[hh] - m_new);"),
         ("const float pr = exp2f((s[j][e] - m[e / 2]) * kLog2e);",
          "const float pr = expf(s[j][e] - m[e / 2]);")],
        "fwd", FWD_PROBLEM),
    # scores, m and the mask in log2 units (log2(e) folded into the
    # scale), P = exp2(s - m); m back in natural units for lse and #5's m
    "fwd_exp2_log2_units": (
        "flash_attention_fwd",
        [("constexpr float kLog2e = 1.4426950408889634f;",
          "constexpr float kLog2e = 1.4426950408889634f, "
          "kLn2 = 0.6931471805599453f;"),
         ("s[j][2 * hh] = s[j][2 * hh] * p.scale + add.x;",
          "s[j][2 * hh] = (s[j][2 * hh] * p.scale + add.x) * kLog2e;"),
         ("s[j][2 * hh + 1] = s[j][2 * hh + 1] * p.scale + add.y;",
          "s[j][2 * hh + 1] = (s[j][2 * hh + 1] * p.scale + add.y) * kLog2e;"),
         ("s[j][2 * hh] *= p.scale;", "s[j][2 * hh] *= p.scale * kLog2e;"),
         ("s[j][2 * hh + 1] *= p.scale;",
          "s[j][2 * hh + 1] *= p.scale * kLog2e;"),
         ("""            x = kMaskedScore;
          if (key >= p.Tk) x = -INFINITY;  // excluded from the max and sums""",
          """            x = kMaskedScore * kLog2e;
          if (key >= p.Tk) x = -INFINITY;  // excluded from the max and sums"""),
         ("alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);",
          "alpha[hh] = exp2f(m[hh] - m_new);"),
         ("const float pr = exp2f((s[j][e] - m[e / 2]) * kLog2e);",
          "const float pr = exp2f(s[j][e] - m[e / 2]);"),
         ("float mv = kPartial ? kMaskedScore : -INFINITY, lv = 0.f;",
          "float mv = kPartial ? kMaskedScore * kLog2e : -INFINITY, "
          "lv = 0.f;"),
         ("      mv = p.m_in[row];", "      mv = p.m_in[row] * kLog2e;"),
         ("        p.lse[row] = m[hh];", "        p.lse[row] = m[hh] * kLn2;"),
         ("p.lse[row] = m[hh] + logf(l[hh]);",
          "p.lse[row] = m[hh] * kLn2 + logf(l[hh]);")],
        "fwd", FWD_PROBLEM),
    "dv_three_terms_in_7": (
        "flash_attention_bwd",
        [("""          tc::mma_bf16(t, pl, oh[2 * n], oh[2 * n + 1]);
          tc::mma_bf16(t, pm, om[2 * n], om[2 * n + 1]);
          tc::mma_bf16(t, ph, ol[2 * n], ol[2 * n + 1]);
""", "")], "dkv_partial", RING_PROBLEM),
    "dq_64_key_tiles_at_d64": (
        "flash_attention_bwd",
        [("static constexpr int kKeys = DMAX <= 32 ? 64 : 32;",
          "static constexpr int kKeys = DMAX <= 64 ? 64 : 32;")],
        "dq", DQ_PROBLEM),
}


def _nvcc(cu, so):
    """Build ``cu`` with the port's flags; headers that are not beside it
    come from csrc/.  The compiler's resource report is kept beside the
    library as ``.ptxas.txt``."""
    from bigdl_tpu_torch.ops.build import CSRC_DIR, NVCC_FLAGS, find_nvcc
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so))


def build_mutant(tag: str) -> ctypes.CDLL:
    """``flash_attention_bwd.cu`` with MUTANTS[tag] applied, built into
    ``_build/mutants/`` with the port's own nvcc flags."""
    from bigdl_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
    before, after, _ = MUTANTS[tag]
    src = (CSRC_DIR / "flash_attention_bwd.cu").read_text()
    if src.count(before) != 1:
        raise RuntimeError(f"{tag}: {before!r} is not in the source once")
    out_dir = BUILD_DIR / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"flash_attention_bwd_{tag}.cu"
    cu.write_text(src.replace(before, after))
    return _nvcc(cu, cu.with_suffix(".so"))


def build_conv_mutant(tag: str) -> ctypes.CDLL:
    """The conv+BN library of CONV_MUTANTS[tag], built with the fault from
    a copy of ``csrc/`` in ``_build/mutants/<tag>/``."""
    from bigdl_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
    path, library, before, after, _, _ = CONV_MUTANTS[tag]
    out_dir = BUILD_DIR / "mutants" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in (*CSRC_DIR.glob("conv_bn_*.cu"), *CSRC_DIR.glob("*.cuh")):
        text = f.read_text()
        if f.name == path:
            if text.count(before) != 1:
                raise RuntimeError(f"{tag}: {before!r} is not in {path} "
                                   "once")
            text = text.replace(before, after)
        (out_dir / f.name).write_text(text)
    cu = out_dir / f"{library}.cu"
    return _nvcc(cu, cu.with_suffix(".so"))


@contextlib.contextmanager
def backward_from(lib):
    """The port's dQ and dK/dV wrappers launch ``lib``'s kernels."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    saved = dict(ak._bound)
    for name in BWD_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = ak._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        ak._bound[("flash_attention_bwd", name)] = fn
    try:
        yield
    finally:
        ak._bound.clear()
        ak._bound.update(saved)


def build_source_variant(library: str, edits, tag: str) -> ctypes.CDLL:
    """``csrc/<library>.cu`` with each (text as it stands, replacement) of
    ``edits`` applied (each text must occur once), built into
    ``_build/mutants/``."""
    from bigdl_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
    src = (CSRC_DIR / f"{library}.cu").read_text()
    for before, after in edits:
        if src.count(before) != 1:
            raise RuntimeError(f"{tag}: {before!r} is not in {library}.cu "
                               "once")
        src = src.replace(before, after)
    out_dir = BUILD_DIR / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{library}_{tag}.cu"
    cu.write_text(src)
    return _nvcc(cu, cu.with_suffix(".so"))


def build_ring_mutant(tag: str) -> ctypes.CDLL:
    """The source of RING_MUTANTS[tag] with its fault, built into
    ``_build/mutants/``."""
    library, before, after, _ = RING_MUTANTS[tag]
    return build_source_variant(library, [(before, after)], tag)


@contextlib.contextmanager
def ring_kernel_from(name: str, lib):
    """The port's wrapper of partial kernel ``name`` launches ``lib``'s."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    entry = f"flash_attention_{name}"
    library, argtypes = (("flash_attention_fwd", ak._PARTIAL_FWD_ARGTYPES)
                         if name == "partial" else
                         ("flash_attention_bwd", ak._PARTIAL_BWD_ARGTYPES))
    saved = dict(ak._bound)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    ak._bound[(library, entry)] = fn
    try:
        yield
    finally:
        ak._bound.clear()
        ak._bound.update(saved)


def phase_ring_mutants():
    problem = next(p for p in chip_smoke._partial_problems()
                   if p[0] == RING_PROBLEM)
    with ThreadPoolExecutor(len(RING_MUTANTS)) as pool:
        libs = dict(zip(RING_MUTANTS, pool.map(build_ring_mutant,
                                               RING_MUTANTS)))
    gen = torch.Generator(device="cuda").manual_seed(7)
    calls = chip_smoke.partial_calls(*chip_smoke.partial_inputs(problem,
                                                                gen))
    readings, failures = {}, []
    for tag, (_, _, _, name) in RING_MUTANTS.items():
        print(f"ring mutant {tag} at ({RING_PROBLEM}) {problem[1]}, check "
              f"tolerances {chip_smoke.partial_tols(name, problem)}")
        readings[tag] = {}
        base = _ring_outputs(name, calls, problem)
        for label, lib in (("as_it_stands", None), (tag, libs[tag])):
            with (ring_kernel_from(name, lib) if lib is not None
                  else contextlib.nullcontext()):
                checks, same, extra = chip_smoke.check_partial(name, calls,
                                                               problem)
                moved = [float((o != b).float().mean()) for o, b in
                         zip(_ring_outputs(name, calls, problem), base)]
            q, k = calls[name][2][:2]
            sizes = {"acc/l": q.numel(), "m": q[..., 0].numel(),
                     "l": q[..., 0].numel(), "dq": q.numel(),
                     "dk": k.numel(), "dv": k.numel()}
            outputs = {"partial": ("acc/l", "m", "l"), "dq_partial": ("dq",),
                       "dkv_partial": ("dk", "dv")}[name]
            r = {o: dict(max_abs_err=err, entries_differ=differ,
                         share_differ=differ / sizes[o], share_moved=mv,
                         check_passes=ok)
                 for o, (err, differ, ok), mv in zip(outputs, checks, moved)}
            r.update(extra)
            readings[tag][label] = r
            for o, v in r.items():
                if o in extra:
                    print(f"  {label:24s} {o}: {v:+.3e}")
                    continue
                print(f"  {label:24s} {o:5s}: {v['entries_differ']} entries "
                      f"differ from the plain version "
                      f"({v['share_differ']:.4%}), {v['share_moved']:.4%} "
                      f"moved from the source as it stands, max abs err "
                      f"{v['max_abs_err']:.3e}; check "
                      f"{'passes' if v['check_passes'] else 'REFUSES'}")
            passes = same and all(v["check_passes"] for o, v in r.items()
                                  if o not in extra)
            if lib is None and not passes:
                failures.append(f"the ring check refuses {name} as it "
                                f"stands")
            if lib is not None and passes:
                failures.append(f"the ring check passes {tag}")
    return readings, failures


def _ring_outputs(name, calls, problem):
    """The outputs of partial kernel ``name`` as its check reads them (#5's
    acc / l, m, l)."""
    kernel, _, args, _ = calls[name]
    with torch.no_grad():
        out = kernel(*args, **chip_smoke.partial_cfg(problem))
    out = list(out) if isinstance(out, tuple) else [out]
    if name == "partial":
        out[0] = out[0] / out[2][..., None]
    return out


@contextlib.contextmanager
def fwd_kernel_from(lib):
    """The port's forward wrapper (#1) launches ``lib``'s kernel."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    saved = dict(ak._bound)
    fn = lib.flash_attention_fwd
    fn.argtypes = ak._FWD_ARGTYPES
    fn.restype = ctypes.c_int
    ak._bound[("flash_attention_fwd", "flash_attention_fwd")] = fn
    try:
        yield
    finally:
        ak._bound.clear()
        ak._bound.update(saved)


def _fwd_problem():
    """chip_smoke's #1 problem FWD_PROBLEM: (q, k, v, bias, causal)."""
    gen = torch.Generator(device="cuda").manual_seed(1)   # chip_smoke's
    return next(r for r in chip_smoke._inputs(gen) if r[0] == FWD_PROBLEM)


def phase_fwd_mutants():
    """Each FWD_MUTANTS fault through #1's wrapper at FWD_PROBLEM, held by
    chip_smoke's #1 check (fwd_held) against the plain version."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    with ThreadPoolExecutor(len(FWD_MUTANTS)) as pool:
        libs = dict(zip(FWD_MUTANTS, pool.map(
            lambda t: build_source_variant("flash_attention_fwd",
                                           [FWD_MUTANTS[t]], t),
            FWD_MUTANTS)))
    _, desc, (q, k, v, bias, causal), _ = _fwd_problem()
    with torch.no_grad():
        want = ak.plain_attention(q, k, v, bias, causal=causal)
        base = ak.dot_product_attention(q, k, v, bias, causal=causal)
    readings, failures = {}, []
    for tag, lib in libs.items():
        print(f"fwd mutant {tag} at ({FWD_PROBLEM}) {desc}")
        readings[tag] = {}
        for label, built in (("as_it_stands", None), (tag, lib)):
            with (fwd_kernel_from(built) if built is not None
                  else contextlib.nullcontext()), torch.no_grad():
                got = ak.dot_product_attention(q, k, v, bias, causal=causal)
            torch.cuda.synchronize()
            err, differ, ok = chip_smoke.fwd_held(got, want)
            r = dict(max_abs_err=err, entries_differ=differ,
                     share_differ=differ / want.numel(),
                     share_moved=float((got != base).float().mean()),
                     error_bias=chip_smoke.state_bias(got, want),
                     check_passes=ok)
            readings[tag][label] = r
            print(f"  {label:24s} out: {differ} entries differ from the "
                  f"plain version ({r['share_differ']:.4%}), "
                  f"{r['share_moved']:.4%} moved from the source as it "
                  f"stands, max abs err {err:.3e}, error bias "
                  f"{r['error_bias']:+.3e}; check "
                  f"{'passes' if ok else 'REFUSES'}")
            if built is None and not ok:
                failures.append("the #1 check refuses the source as it "
                                "stands")
            if built is not None and ok:
                failures.append(f"the #1 check passes {tag}")
    return readings, failures


def phase_variants():
    """Each of VARIANTS against the source as it stands on the same inputs
    in one run: device times (as it stands, the variant, as it stands
    again) and whether chip_smoke's check passes it.  A reading, not a
    gate: it records what a design choice buys."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda t: build_source_variant(VARIANTS[t][0], VARIANTS[t][1], t),
            VARIANTS)))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    _, _, (q, k, v, bias, causal), _ = _fwd_problem()
    problem = next(p for p in chip_smoke._partial_problems()
                   if p[0] == RING_PROBLEM)
    gen = torch.Generator(device="cuda").manual_seed(7)
    calls = chip_smoke.partial_calls(*chip_smoke.partial_inputs(problem,
                                                                gen))
    dq_args, dq_cfg, dq_want, dq_floor = _dq_problem()
    readings = {}
    for tag, (_, _, kernel, key) in VARIANTS.items():
        if kernel == "dq":
            def run():
                return ak.flash_attention_dq(*dq_args, **dq_cfg)

            def held():
                return chip_smoke.bwd_held("dq", run(), dq_want,
                                           dq_floor)[2]
            context = backward_from
        elif kernel == "fwd":
            def run():
                return ak.dot_product_attention(q, k, v, bias, causal=causal)
            want = ak.plain_attention(q, k, v, bias, causal=causal)

            def held():
                return chip_smoke.fwd_held(run(), want)[2]
            context = fwd_kernel_from
        else:
            fn, _, args, _ = calls[kernel]
            cfg = chip_smoke.partial_cfg(problem)

            def run():
                return fn(*args, **cfg)

            def held():
                checks, _, _ = chip_smoke.check_partial(kernel, calls,
                                                        problem)
                return all(ok for _, _, ok in checks)
            context = functools.partial(ring_kernel_from, kernel)
        r = {}
        with torch.no_grad():
            base = run()
            for label, lib in (("as_it_stands", None), (tag, libs[tag]),
                               ("as_it_stands_again", None)):
                with (context(lib) if lib is not None
                      else contextlib.nullcontext()):
                    out = run()
                    same = all(torch.equal(a, b) for a, b in zip(
                        out if isinstance(out, tuple) else (out,),
                        base if isinstance(base, tuple) else (base,)))
                    r[label] = dict(
                        ms=chip_smoke.time_ms(run, flush, runs=30),
                        check_passes=held(), same_bits_as_it_stands=same)
        from bigdl_tpu_torch.ops.build import BUILD_DIR
        report = chip_smoke.ptxas_report(
            (BUILD_DIR / "mutants" / f"{VARIANTS[tag][0]}_{tag}.ptxas.txt")
            .read_text())
        r["build"] = {k: v for k, v in report.items()
                      if any(n in k for n in chip_smoke.TC_KERNELS)}
        readings[tag] = r
        print(f"variant {tag} build: " + "; ".join(
            f"{re.search(r'(flash_[a-z_]+kernel\w*?)EEEv', k).group(1)} "
            f"{v['registers']} "
            f"registers, spills {v['spill_stores']}/{v['spill_loads']}"
            for k, v in r["build"].items()))
        print(f"variant {tag} at ({key}): " + "; ".join(
            f"{label} {x['ms']:.5f} ms, check "
            f"{'passes' if x['check_passes'] else 'REFUSES'}, "
            f"{'the same' if x['same_bits_as_it_stands'] else 'other'} bits"
            for label, x in r.items() if label != "build"))
    return readings


def _dq_problem():
    """chip_smoke's #2 problem DQ_PROBLEM: (args, cfg, the plain dQ, its
    rounding floor)."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    gen = torch.Generator(device="cuda").manual_seed(2)   # chip_smoke's
    _, _, (q, k, v), bias, causal, _ = next(
        r for r in chip_smoke._bwd_inputs(gen) if r[0] == DQ_PROBLEM)
    cfg = dict(scale=q.shape[-1] ** -0.5, causal=causal,
               causal_offset=k.shape[2] - q.shape[2])
    with torch.no_grad():
        out, lse = ak.flash_attention_fwd(q, k, v, bias, **cfg)
        do = torch.randn(out.shape, generator=gen, device="cuda").to(q.dtype)
        args = (q, k, v, bias, do, lse, ak.attention_delta(out, do))
        return (args, cfg, ak.plain_attention_dq(*args, **cfg),
                chip_smoke.bwd_floors(*args, **cfg)[0])


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude of ``x``'s largest entry."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def phase_mutants():
    from bigdl_tpu_torch.ops import attention_kernels as ak
    from bigdl_tpu_torch.ops.build import load_library
    gen = torch.Generator(device="cuda").manual_seed(2)   # chip_smoke's
    key, desc, (q, k, v), bias, causal, _ = chip_smoke._bwd_inputs(gen)[0]
    d, tq, tk = q.shape[-1], q.shape[2], k.shape[2]
    cfg = dict(scale=d ** -0.5, causal=causal, causal_offset=tk - tq)
    with ThreadPoolExecutor(len(MUTANTS)) as pool:
        libs = dict(zip(MUTANTS, pool.map(build_mutant, MUTANTS)))
    libs = {"as_it_stands": load_library("flash_attention_bwd"), **libs}
    with torch.no_grad():
        out, lse = ak.flash_attention_fwd(q, k, v, bias, **cfg)
        do = torch.randn(out.shape, generator=gen,
                         device="cuda").to(q.dtype)
        args = (q, k, v, bias, do, lse, ak.attention_delta(out, do))
        want = dict(zip(("dq", "dk", "dv"),
                        (ak.plain_attention_dq(*args, **cfg),
                         *ak.plain_attention_dkv(*args, **cfg))))
        floors = dict(zip(("dq", "dk", "dv"),
                          chip_smoke.bwd_floors(*args, **cfg)))
    kernel_of = {"dq": "dq", "dk": "dkv", "dv": "dkv"}
    print(f"mutants at ({key}) {desc}, check rules: dq "
          f"{chip_smoke.bwd_rule('dq', q.dtype)}; dk, dv "
          f"{chip_smoke.bwd_rule('dkv', q.dtype)}")
    readings, failures = {}, []
    for tag, lib in libs.items():
        with torch.no_grad(), backward_from(lib):
            got = dict(zip(("dq", "dk", "dv"),
                           (ak.flash_attention_dq(*args, **cfg),
                            *ak.flash_attention_dkv(*args, **cfg))))
        torch.cuda.synchronize()
        readings[tag] = {}
        for name, g in got.items():
            w = want[name]
            err, differ, ok = chip_smoke.bwd_held(kernel_of[name], g, w,
                                                  floors[name])
            top = float(w.float().abs().max())
            loose = bool(torch.allclose(g.float(), w.float(), rtol=LOOSE_REL,
                                        atol=LOOSE_REL * top))
            r = dict(max_abs_err=err, entries_differ=differ,
                     share_differ=differ / w.numel(),
                     max_err_ulps_of_largest=err / _ulp(w),
                     check_passes=ok, loose_tolerance_passes=loose)
            readings[tag][name] = r
            print(f"  {tag:17s} {name}: {differ} of {w.numel()} entries "
                  f"differ ({r['share_differ']:.4%}), max abs err "
                  f"{err:.3e} = {r['max_err_ulps_of_largest']:.3f} ulp of "
                  f"the largest entry; check "
                  f"{'passes' if ok else 'REFUSES'}; 2e-2 of the largest "
                  f"{'passes' if loose else 'refuses'}")
        if tag == "as_it_stands":
            if not all(r["check_passes"] for r in readings[tag].values()):
                failures.append("the check refuses the source as it stands")
        elif readings[tag][MUTANTS[tag][2]]["check_passes"]:
            failures.append(f"the check passes {tag}")
    return readings, failures


def _in_bf16(kernel):
    """``kernel`` on q, k, v and dO rounded to bf16, its outputs in f32."""
    def run(q, k, v, bias, do, lse, delta, **cfg):
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        out = kernel(q, k, v, bias, do, lse, delta, **cfg)
        if torch.is_tensor(out):
            return out.float()
        return tuple(t.float() for t in out)
    return run


def phase_control_step():
    from bigdl_tpu_torch.ops import attention_kernels as ak
    on_card, on_cpu, step = chip_smoke.parity_setup()
    cpu = step(on_cpu, "cpu")
    card = step(on_card, "cuda")
    as_is = chip_smoke.parity_report(card, cpu, "step as it is")
    saved = ak._KERNELS
    fwd, dq, dkv, dbias = saved
    before = (dq.launches, dkv.launches)
    ak._KERNELS = (fwd, _in_bf16(dq), _in_bf16(dkv), dbias)
    try:
        card_bf16 = step(on_card, "cuda")
    finally:
        ak._KERNELS = saved
    if (dq.launches - before[0], dkv.launches - before[1]) != \
            (chip_smoke.LAYERS,) * 2:
        raise RuntimeError("the bf16 control did not go through the kernels")
    bf16 = chip_smoke.parity_report(card_bf16, cpu,
                                    "attention backward in bf16")
    readings = {
        label: dict(worst_norm_err=n, worst_entry_err=m, within_bounds=ok)
        for label, (n, m, ok) in (("as_it_is", as_is),
                                  ("backward_in_bf16", bf16))}
    failures = []
    if not as_is[2]:
        failures.append("the step as it is breaks the bounds")
    if bf16[2]:
        failures.append("the bounds pass the step with a bf16 backward")
    return readings, failures


@contextlib.contextmanager
def conv_kernels_from(library: str, lib):
    """The port's conv+BN wrappers of ``library`` launch ``lib``'s
    kernels."""
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    saved = dict(ck._bound)
    for (name_lib, name), argtypes in ck._ARGTYPES.items():
        if name_lib == library:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            ck._bound[(name_lib, name)] = fn
    try:
        yield
    finally:
        ck._bound.clear()
        ck._bound.update(saved)


def phase_conv_mutants():
    problems = {p[0]: p for p in chip_smoke.conv_problems()}
    with ThreadPoolExecutor(len(CONV_MUTANTS)) as pool:
        libs = dict(zip(CONV_MUTANTS, pool.map(build_conv_mutant,
                                               CONV_MUTANTS)))
    readings, failures = {}, []
    for tag, (_, library, _, _, key, guarded) in CONV_MUTANTS.items():
        _, kind, shape, dtype, norm = problems[key]
        gen = torch.Generator(device="cuda").manual_seed(3)
        inputs = chip_smoke.conv_inputs(kind, shape, dtype, gen)
        print(f"conv mutant {tag} at ({key}) "
              f"{chip_smoke.conv_what(kind, shape, dtype, norm)}")
        readings[tag] = {}
        for label, lib in (("as_it_stands", None), (tag, libs[tag])):
            with (conv_kernels_from(library, lib) if lib is not None
                  else contextlib.nullcontext()):
                held, _, same = chip_smoke.check_conv(kind, *inputs, norm)
            r = {name: dict(max_abs_err=err, entries_differ=differ,
                            share_differ=differ / _numel(kind, shape, name),
                            check_passes=ok)
                 for name, (err, differ, ok) in held.items()
                 if name in guarded}
            readings[tag][label] = r
            for name, v in r.items():
                print(f"  {label:30s} {name}: {v['entries_differ']} entries "
                      f"differ ({v['share_differ']:.4%}), max abs err "
                      f"{v['max_abs_err']:.3e}; check "
                      f"{'passes' if v['check_passes'] else 'REFUSES'}")
            passes = all(v["check_passes"] for v in r.values()) and same
            if lib is None and not passes:
                failures.append(f"the conv check refuses the sources as "
                                f"they stand at {key}")
            if lib is not None and passes:
                failures.append(f"the conv check passes {tag}")
    return readings, failures


def _numel(kind, shape, output):
    """Entries of one output of chip_smoke's conv problem."""
    if kind == "1x1":
        m, c, co = shape
        return {"y": m * co, "dx": m * c, "dw": c * co}[output]
    b, h, w, c, co = shape
    return {"y": b * h * w * co, "dx": b * h * w * c,
            "dw": 9 * c * co}[output]


def _rounded(kernel):
    """``kernel`` on x and W rounded to bf16 (kept in f32)."""
    def run(x, w, *rest, **flags):
        return kernel(x.to(torch.bfloat16).float(),
                      w.to(torch.bfloat16).float(), *rest, **flags)
    return run


def phase_resnet_control_step():
    import copy
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    on_card, on_cpu, step = chip_smoke.resnet_parity_setup()
    control = copy.deepcopy(on_card)
    perturbed = [step(copy.deepcopy(on_cpu), "cpu", perturb=seed)
                 for seed in range(3)]
    cpu = step(on_cpu, "cpu")
    card = step(on_card, "cuda")
    as_is = chip_smoke.resnet_parity_report(card, cpu,
                                            "resnet step as it is")
    noise = [chip_smoke.resnet_parity_report(
        p, cpu, f"cpu step, inputs moved by 2^-23 (seed {seed})")
        for seed, p in enumerate(perturbed)]
    kernels = ck._KERNELS
    before = chip_smoke._read_counts()
    ck._KERNELS = tuple(_rounded(k) for k in kernels)
    try:
        card_rounded = step(control, "cuda")
    finally:
        ck._KERNELS = kernels
    after = chip_smoke._read_counts()
    if {n: after[n] - before[n] for n in chip_smoke.RESNET_LAUNCHES} != \
            chip_smoke.RESNET_LAUNCHES:
        raise RuntimeError("the rounded control did not go through the "
                           "kernels")
    rounded = chip_smoke.resnet_parity_report(
        card_rounded, cpu, "conv kernels on bf16-rounded x and W")
    readings = {
        label: dict(worst_norm_err=n, worst_entry_err=m, within_bounds=ok)
        for label, (n, m, ok) in (
            ("as_it_is", as_is), ("inputs_rounded_to_bf16", rounded),
            *((f"cpu_inputs_moved_2^-23_seed{s}", r)
              for s, r in enumerate(noise)))}
    failures = []
    if not as_is[2]:
        failures.append("the ResNet step as it is breaks the bounds")
    if rounded[2]:
        failures.append("the bounds pass the ResNet step with bf16-rounded "
                        "conv inputs")
    return readings, failures


def main() -> int:
    chip_smoke.phase_device()
    mutants, failures = phase_mutants()
    control, more = phase_control_step()
    failures += more
    conv_mutants, more = phase_conv_mutants()
    failures += more
    ring_mutants, more = phase_ring_mutants()
    failures += more
    fwd_mutants, more = phase_fwd_mutants()
    failures += more
    variants = phase_variants()
    resnet_control, more = phase_resnet_control_step()
    failures += more
    print(json.dumps({"mutants": mutants, "control_step": control,
                      "bounds": {"grad_norm_rel": chip_smoke.GRAD_NORM_REL,
                                 "grad_max_rel": chip_smoke.GRAD_MAX_REL},
                      "conv_mutants": conv_mutants,
                      "ring_mutants": ring_mutants,
                      "fwd_mutants": fwd_mutants, "variants": variants,
                      "resnet_control_step": resnet_control,
                      "resnet_bounds": chip_smoke.RESNET_PARITY_BOUNDS,
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
