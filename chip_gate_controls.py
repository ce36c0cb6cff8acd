#!/usr/bin/env python3
"""Show, on one NVIDIA GPU, that chip_smoke.py's backward checks refuse
the faults they are there to catch:

    python3 chip_gate_controls.py        # from the repository root

1. Kernel mutants.  ``flash_attention_bwd.cu`` is rebuilt, into the
   git-ignored build directory, with one of the reference's bf16 rounding
   points taken out: dS before dS·K (the dQ kernel), dS before dSᵀ·Q
   (dK), P before Pᵀ·dO (dV).  Each mutant runs through the port's own
   wrappers at chip_smoke's training shape (t), and its outputs go
   through chip_smoke's check against the plain versions.  The script
   fails unless that check passes the source as it stands and refuses
   every mutant.  Beside each output it prints how many entries moved,
   the largest move in ulps of the largest entry, and whether a
   tolerance of 2e-2 of the largest entry would have seen it.
2. A control training step.  chip_smoke's f32 step (the full-width LM at
   batch 2, card against a CPU copy) runs as it is and again with the
   attention backward in bf16: q, k, v and dO rounded to bf16 before the
   dQ and dK/dV kernels.  The script fails unless the first stays within
   chip_smoke's bounds and the second does not.

The last line is one JSON object with every reading.  Imports torch,
numpy, ``bigdl_tpu_torch`` and ``chip_smoke`` only.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke

# name: (the line as it stands, the line without the cast, the output)
MUTANTS = {
    "no_ds_cast_in_dq": ("const float dsk = round_to<T>(ds);",
                         "const float dsk = ds;", "dq"),
    "no_ds_cast_in_dk": ("const float dsq = round_to<T>(ds);",
                         "const float dsq = ds;", "dk"),
    "no_p_cast_in_dv": ("const float pd = round_to<T>(pr);",
                        "const float pd = pr;", "dv"),
}
LOOSE_REL = 2e-2   # a tolerance relative to the largest entry
BWD_ENTRIES = ("flash_attention_dq", "flash_attention_dkv")


def build_mutant(tag: str) -> ctypes.CDLL:
    """``flash_attention_bwd.cu`` with MUTANTS[tag] applied, built into
    ``_build/mutants/`` with the port's own nvcc flags."""
    from bigdl_tpu_torch.ops.build import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS,
                                           find_nvcc)
    before, after, _ = MUTANTS[tag]
    src = (CSRC_DIR / "flash_attention_bwd.cu").read_text()
    if src.count(before) != 1:
        raise RuntimeError(f"{tag}: {before!r} is not in the source once")
    out_dir = BUILD_DIR / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"flash_attention_bwd_{tag}.cu"
    cu.write_text(src.replace(before, after))
    so = cu.with_suffix(".so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


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


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude of ``x``'s largest entry."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def phase_mutants():
    from bigdl_tpu_torch.ops import attention_kernels as ak
    from bigdl_tpu_torch.ops.build import load_library
    gen = torch.Generator(device="cuda").manual_seed(2)   # chip_smoke's
    key, desc, (q, k, v), bias, causal, _, tol = \
        chip_smoke._bwd_inputs(gen)[0]
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
    print(f"mutants at ({key}) {desc}, check tolerance "
          f"{tol or 'bit for bit'}")
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
            err, differ, ok = chip_smoke._close(g, w, tol)
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


def main() -> int:
    chip_smoke.phase_device()
    mutants, failures = phase_mutants()
    control, more = phase_control_step()
    failures += more
    print(json.dumps({"mutants": mutants, "control_step": control,
                      "bounds": {"grad_norm_rel": chip_smoke.GRAD_NORM_REL,
                                 "grad_max_rel": chip_smoke.GRAD_MAX_REL},
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
