#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card
    python3 chip_smoke.py --step resnet|sp [--dispatch k]   # one path alone

Phases, each raising on failure (the script then exits non-zero):

1. device: the card's name, its ``nvidia-smi`` name and power limit, and
   the TF32 settings (f32 matmuls are set to full f32);
2. build: the four CUDA sources from the checkout (the flash-attention
   forward #1 and the ring's partial merge #5; its three backward kernels
   #2-#4 and the ring's partial dQ #6 and dK/dV #7; the fused conv+BN
   forward kernels #8 and #10 and backward kernels #9 and #11), one
   ``nvcc`` each in parallel, with their register and spill reports, and
   for the tensor-core kernels (the bf16 routes of #1-#3 and #5-#11)
   their registers, shared memory, spills and count of HMMA instructions
   (``cuobjdump``), which must not be 0;
3. the forward kernel against its plain PyTorch version at the serving
   path's shapes, with times (CUDA events, median of 60 runs, L2 flushed
   before each): the kernel, the plain version,
   ``scaled_dot_product_attention`` with the same additive mask (a
   yardstick the port never calls) and the card's bound for the same
   work; besides, at the LM training shape (B8 H8 T2048 D64 causal bf16),
   against SDPA's causal forward, and at bf16 edge shapes (the padded
   LM's bias, ragged, D36, the decode); each row with the route it took,
   bf16 rows on the tensor cores held besides by the bias of their error
   (``fwd_held``) and timed beside the scalar template;
4. the backward kernels (dQ, dK/dV, dBias) against their plain versions
   on the same inputs and the forward kernel's lse, at the training
   shape, bf16 edge shapes of #2's and #3's tensor-core routes and six
   f32 edge shapes, each launched twice to show the same bits, with times
   beside the plain version, SDPA's backward and the bound (bf16 dQ and
   dK/dV by the rule of ``bwd_held``; the tensor-core dQ rows' device
   time from ``torch.profiler``);
4b. the ring-attention kernels #5-#7 against their plain versions, f32
   and bf16, at the sequence-parallel training path's chunk pairs (B8 H8
   Tc512 D64: a diagonal pair from the fresh state, an off-diagonal and a
   non-causal pair from a carried state) and at a ragged pair whose
   offsets are not tile multiples; each launched twice to show the same
   bits, with times beside the plain version, SDPA on the same chunk pair
   and mask (which merges no carried state) and the bound (bf16 #5 on the
   tensor cores, held by the rule of ``partial_state_held``; bf16 #6 and
   #7 on the tensor cores with their f32 operands in bf16 pieces, held by
   ``partial_ulp_held`` and ``dkv_partial_held`` and timed beside their
   scalar templates; the tensor-core rows' device time split by kernel
   with ``torch.profiler``);
5. serving: a TransformerLM at the width of the largest LM the repo
   serves (vocab 32000, hidden 512, 6 layers, 8 heads, filter 1024,
   max_len 512; random weights from a seed) behind ``ModelServer`` and
   the continuous-batching engine with 128-wide prefill chunks, 32
   requests; every served row is held against a solo ``generate()`` and
   the kernel's launch count against the path's attention calls, every
   launch by the scalar route (f32);
6. training: the port's ``examples.perf`` training path at the width of
   the reference's transformer perf run (L6 H512 T2048 b8, vocab 32000,
   filter 2048, bf16 compute) through ``Optimizer.optimize()``; the loss
   must stay finite and fall, and every step must launch the forward,
   dQ and dK/dV kernels once per layer (dBias never: no bias), every
   forward, dQ and dK/dV launch by the tensor-core route; the step's time
   is split into #1-#3 and the rest;
7. one f32 training step at batch 2, on the card and on a CPU copy of
   the same model (plain attention): loss and every gradient must agree;
   its forward, dQ and dK/dV launches take the scalar route;
7b. sequence-parallel training: the same LM and run with every block's
   attention through ring attention over a 4-shard ``seq`` mesh on the
   one card (``set_sequence_parallel``); every step must launch #5, #6
   and #7 once per layer and visible chunk pair (6 x 10) and #1-#4 never,
   and the loss must stay finite and fall, every #5, #6 and #7 launch by
   the tensor-core route; the step's time is split into the three kernels
   and the rest;
7c. one f32 step at batch 2, the ring LM (#5-#7) against the dense LM
   (#1-#3) from the same weights and tokens: loss and every gradient must
   agree within phase 7's bounds; #1-#3 and #5-#7 by the scalar route;
8. the conv+BN kernels #8-#11 against their plain versions, forward and
   backward, with nonzero statistics cotangents, at ResNet-50's own b128
   shapes and at ragged small ones in f32 and bf16, each launched twice
   to show the same bits, with times beside the plain version, the
   cuBLAS/cuDNN product alone and the bound, and for the tensor-core
   routes (#8-#11 in bf16) the device time split among their prepass,
   products and reductions (``torch.profiler``); both backwards fold the
   forward kernel's y, as the autograd Functions save it;
9. ResNet-50 training: ``examples.perf`` with ``--model resnet50 --fused
   --bf16 -b 128 --image-size 224 --classes 1000``; every step must
   launch #8/#9/#10/#11 exactly 32/32/13/13 times, all by the tensor-core
   route, the loss must stay finite and fall; the step's time is split
   into the four kernels and the rest, and the run's peak memory printed;
10. one bf16 step with the fused path and one with
   ``BIGDL_TPU_TORCH_FUSED_CONVBN=0``, from the same weights and batch:
   losses and every BatchNorm running statistic must agree;
11. one f32 fused ResNet-50 step at batch 4, 64 px, on the card and on a
   CPU copy (the kernels' plain versions): loss and every gradient must
   agree; #8-#11 by the scalar route;
12. LeNet-5 at the reference perf's width (``--model lenet -b 256
   --iterations 50``, 4 epochs, f32) through the Optimizer with
   every-epoch validation (Top1, Top5, Loss), an L2 regularizer on fc1
   and clipping by the L2 norm: eagerly, then with windows of 50 steps
   (CUDA graph replays), deterministic algorithms on for both; the graph
   run's losses, parameters and validations must equal the eager run's
   bit for bit, and 20 f32 steps on the card (graph windows) a CPU copy's
   (loss 1e-5, parameters 1e-4 in norm); images/s, ms/iteration, device
   busy time, idle share and peak memory of both runs;
13. dispatch: the LM, the SP LM and ResNet-50 at the configurations of
   phases 6, 7b and 9, each eagerly and with windows of an epoch's
   iterations (graph replays), deterministic algorithms on for both,
   each run under ``torch.profiler``: losses, parameters and buffers
   equal bit for bit; the wrappers count every eager step's launches and
   the graph run's warm-up step's and capture's, all by the tensor-core
   route; the run's own device events hold each kernel once a launch in
   the eager run, and in the graph run once in the warm-up step before a
   marker kernel that follows the capture and a step's worth per replay
   after it; ms per iteration, device busy time, idle share and peak
   memory of both;
14. a ``{"kernels": [...]}`` line (eleven kernels, launches by path,
   the graph replays' among them as the profiler counted them on the
   device; all but #4 also their design, launches by route and build
   report; #1 its row at the training shape beside the decode row), then
   the ``{"ok": true, ...}`` line.

Imports torch, numpy and ``bigdl_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

F32_TOL = dict(rtol=1e-4, atol=2e-5)   # f32: only the summation order differs
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 inputs and output
NEAR_TIE = 1e-3                        # top-2 logit margin of a near-tie

VOCAB, HIDDEN, LAYERS, HEADS, FILTER, MAX_LEN = 32000, 512, 6, 8, 1024, 512
SLOTS, PREFILL_CHUNK, PREFILL_BATCH, N_REQUESTS = 16, 128, 4, 32

# Published dense peaks at the full power limit (NVIDIA data sheets):
# device-memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 FLOP/s.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12),   # H100 SXM
    "H200": (4.8e12, 67e12, 989e12),
}


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peak rates on file for {name!r}; "
                       "add the card to CARDS before quoting a bound")


def _wrappers():
    """Every kernel wrapper of the port: each counts its launches."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    return (ak.flash_attention_fwd, ak.flash_attention_dq,
            ak.flash_attention_dkv, ak.flash_attention_dbias,
            ak.flash_attention_partial, ak.flash_attention_dq_partial,
            ak.flash_attention_dkv_partial,
            ck.matmul_bn_fwd, ck.matmul_bn_bwd, ck.conv3x3_bn_fwd,
            ck.conv3x3_bn_bwd)


def _zero_counts():
    for w in _wrappers():
        w.launches = 0
        for route in getattr(w, "routes", ()):
            w.routes[route] = 0


def _read_counts():
    return {w.__name__: w.launches for w in _wrappers()}


def _read_routes():
    """{wrapper: {route: launches}} of the wrappers with two routes (#1,
    #2, #3, #5, #7, #9, #10 and #11: tensor cores for bf16, scalar for
    f32)."""
    return {w.__name__: dict(w.routes) for w in _wrappers()
            if hasattr(w, "routes")}


def _check_routes(routes, name, want, what):
    """Raise unless wrapper ``name`` took the routes ``want`` exactly."""
    if routes[name] != want:
        raise RuntimeError(f"{what}: {name} took the routes {routes[name]}, "
                           f"not {want}")


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this "
                           "script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: set torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    return smi


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, smem}} from an
    ``nvcc -Xptxas -v`` report (smem: bytes of static shared memory)."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            report[name] = {"registers": 0, "spill_stores": 0,
                            "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name]["spill_stores"] = int(m.group(1))
            report[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(s.group(1)) if s else 0
    return report


def tensor_core_counts(sass: str) -> dict:
    """{kernel: count of HGMMA or HMMA instructions} from ``cuobjdump
    -sass``."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b|\bH(G)?MMA\.",
                                            line):
            counts[name] += 1
    return counts


# the kernels redesigned for the tensor cores, by a part of their
# (mangled) names: #2's and #6's dQ loop (flash_dq_tc_kernel<D, false|true>),
# #3's dK/dV, #1's and #5's forward loop (flash_fwd_tc_kernel<false|true,
# D>), #7's split dK/dV, and the conv kernels of conv_bn_tc.cuh by their
# tap count (#10's prepass and fprop, #11's prepass, dgrad, wgrad and dW
# sum with 9 taps; #8's prepass and fprop, #9's prepass, dgrad, wgrad and
# dW sum with 1); the products on the tensor cores (all but the prepasses
# and the sums) must hold HMMA instructions
TC_KERNELS = ("flash_dq_tc_kernel", "flash_dkv_tc_kernel",
              "flash_fwd_tc_kernel", "flash_dkv_partial_tc_kernel", "tcconv")
TC_PRODUCTS = ("flash_dq_tc_kernel", "flash_dkv_tc_kernel",
               "flash_fwd_tc_kernel", "flash_dkv_partial_tc_kernel",
               "tcconv5fprop", "tcconv5dgrad", "tcconv5wgrad")
# each redesigned wrapper's kernels among them: (library, name parts)
TC_BUILD = {
    "flash_attention_fwd": ("flash_attention_fwd",
                            ("flash_fwd_tc_kernelILb0E",)),
    "flash_attention_dq": ("flash_attention_bwd",
                           tuple(f"flash_dq_tc_kernelILi{d}ELb0E"
                                 for d in (32, 64, 128))),
    "flash_attention_dq_partial": ("flash_attention_bwd",
                                   tuple(f"flash_dq_tc_kernelILi{d}ELb1E"
                                         for d in (32, 64, 128))),
    "flash_attention_dkv": ("flash_attention_bwd", ("flash_dkv_tc_kernel",)),
    "flash_attention_partial": ("flash_attention_fwd",
                                ("flash_fwd_tc_kernelILb1E",)),
    "flash_attention_dkv_partial": ("flash_attention_bwd",
                                    ("flash_dkv_partial_tc_kernel",)),
    "matmul_bn_fwd": ("conv_bn_fwd", ("tcconv7prepassILi1E",
                                      "tcconv5fpropILi1E")),
    "matmul_bn_bwd": ("conv_bn_bwd", ("tcconv7prepassILi1E",
                                      "tcconv5dgradILi1E",
                                      "tcconv5wgradILi1E",
                                      "tcconv9reduce_dwILi1E")),
    "conv3x3_bn_fwd": ("conv_bn_fwd", ("tcconv7prepassILi9E",
                                       "tcconv5fpropILi9E")),
    "conv3x3_bn_bwd": ("conv_bn_bwd", ("tcconv7prepassILi9E",
                                       "tcconv5dgradILi9E",
                                       "tcconv5wgradILi9E",
                                       "tcconv9reduce_dwILi9E")),
}


def _cuobjdump():
    from bigdl_tpu_torch.ops.build import find_nvcc
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = Path(find_nvcc()).parent / "cuobjdump"
    return str(beside) if beside.is_file() else None


def phase_build():
    """Build every kernel source at once (one nvcc each, in parallel),
    then print each library's register and spill totals, and for each
    tensor-core kernel its registers, shared memory, spills and (where
    cuobjdump exists) its count of tensor-core instructions.  Returns
    {library: {kernel: report}} of the tensor-core kernels."""
    from bigdl_tpu_torch.ops.build import (KERNEL_SOURCES, build_all,
                                           load_library)
    t0 = time.perf_counter()
    libs = build_all(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        load_library(name)
    print(f"build: {', '.join(n + '.cu' for n in KERNEL_SOURCES)} built "
          f"and loaded in {time.perf_counter() - t0:.3f} s")
    cuobjdump = _cuobjdump()
    tc = {}
    for name, lib in zip(KERNEL_SOURCES, libs):
        report = ptxas_report(lib.with_suffix(".ptxas.txt").read_text())
        spills = sum(r["spill_stores"] + r["spill_loads"]
                     for r in report.values())
        print(f"  {name}.cu: {len(report)} kernels, at most "
              f"{max(r['registers'] for r in report.values())} registers, "
              f"{spills} bytes spilled in all")
        counts = {}
        if cuobjdump is not None:
            counts = tensor_core_counts(subprocess.run(
                [cuobjdump, "-sass", str(lib)], capture_output=True,
                text=True, check=True, timeout=300).stdout)
        tc[name] = {}
        for kernel, r in report.items():
            if not any(k in kernel for k in TC_KERNELS):
                continue
            r["tensor_core_instructions"] = counts.get(kernel)
            tc[name][kernel] = r
            mma = ("not counted (no cuobjdump)" if cuobjdump is None
                   else r["tensor_core_instructions"])
            print(f"    {kernel}: {r['registers']} registers, {r['smem']} "
                  f"bytes static shared memory, spills "
                  f"{r['spill_stores']}/{r['spill_loads']} bytes, "
                  f"HMMA/HGMMA instructions {mma}")
            if (cuobjdump is not None
                    and any(k in kernel for k in TC_PRODUCTS)
                    and not r["tensor_core_instructions"]):
                raise RuntimeError(f"{kernel} holds no tensor-core "
                                   "instruction")
    if cuobjdump is None:
        print("  cuobjdump not found: tensor-core instructions not counted")
    return tc


# ---------------------------------------------------------------------------
# 3. the kernel against its plain version
# ---------------------------------------------------------------------------

def time_ms(fn, flush, runs: int = 60, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` runs.  Before each run
    the L2 cache is flushed (the serving path reads each layer's cache
    cold) and the stream is held busy by a sleep kernel, so the events
    bracket device work only, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_split(fn, runs: int = 5) -> dict:
    """{kernel: device ms per call} of the kernels ``fn`` launches, from
    ``torch.profiler`` over ``runs`` calls after one warm-up: where a
    wrapper's time goes among its prepass, product and reductions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = (split.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / runs / 1e3)
    return split


def _split_text(row) -> str:
    """The row's device split, as printed beside it."""
    split = row.get("device_split_ms")
    if not split:
        return ""
    names = (re.sub(r"[(<].*", "",
                    re.sub(r"^void |\(anonymous namespace\)::", "", n))
             for n in split)
    return "  device " + ", ".join(f"{n} {t:.5f}"
                                   for n, t in zip(names, split.values()))


def _visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs the function needs: all of them, or under the
    end-aligned causal mask the visible ones (a row that sees no key is
    uniform over all keys, so it needs them all)."""
    if not causal:
        return tq * tk
    off = tk - tq
    rows = np.arange(tq) + off
    return int(np.where(rows >= 0, np.minimum(rows + 1, tk), tk).sum())


def bound(q, k, v, bias, causal, rates):
    """Least device time for the call: the larger of the bytes it must
    move (each input read once, the output and lse written once) over
    the memory rate and its flops over the peak rate of its type."""
    mem_rate, f32_rate, bf16_rate = rates
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    nbytes += q.numel() * q.element_size() + b * h * tq * 4
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    flops = 4 * b * h * d * _visible_pairs(tq, tk, causal)
    peak = bf16_rate if q.dtype == torch.bfloat16 else f32_rate
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _inputs(gen):
    """The five shapes of the serving path and its edges, the training
    path's shape, and bf16 rows at the tensor-core route's edges: the
    padded LM's causal+padding bias, ragged Tq != Tk with D padded to 64,
    D36 (rows not on 16 bytes: the scalar route) and the pooled decode."""
    from bigdl_tpu_torch.nn.attention import (causal_bias,
                                              chunk_incremental_bias,
                                              incremental_bias, padding_bias)
    dev = "cuda"

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # (a) a 128-wide prefill chunk at position 200 over a 512-key cache
    pad_a = torch.zeros((1, MAX_LEN), dtype=torch.bool, device=dev)
    pad_a[:, 200 + 128 + 40:] = True
    bias_a = chunk_incremental_bias(MAX_LEN, 200, 128, pad_a)
    # (b) the pooled decode: 16 slots, each at its own position
    index_b = torch.randint(0, MAX_LEN, (SLOTS,), generator=gen, device=dev)
    bias_b = incremental_bias(
        MAX_LEN, index_b, torch.zeros((SLOTS, MAX_LEN), dtype=torch.bool,
                                      device=dev))
    # (c) prefill_kv of a 128 bucket: T = 127, causal + padding bias
    t = 127
    lens = torch.tensor([127, 100, 9, 64], device=dev)
    pad_c = torch.arange(t, device=dev)[None, :] >= lens[:, None]
    causal_c = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    bias_c = (torch.where(causal_c, 0.0, -1e9)[None, None]
              + torch.where(pad_c, -1e9, 0.0)[:, None, None, :])
    bf = torch.bfloat16
    # (g) the padded LM's bias in bf16 (transformer_lm.py), two rows padded
    tokens = torch.ones((2, 256), dtype=torch.long, device=dev)
    tokens[0, 200:] = 0
    tokens[1, 17:] = 0
    bias_g = causal_bias(256, bf, dev) + padding_bias(tokens).to(bf)
    return [
        ("a_chunk", "B1 H8 Tq128 Tk512 D64 f32 chunk bias",
         (rnd(1, 8, 128, 64), rnd(1, 8, MAX_LEN, 64),
          rnd(1, 8, MAX_LEN, 64), bias_a, False), F32_TOL),
        ("b_decode", "S16 H8 Tq1 Tk512 D64 f32 per-slot bias",
         (rnd(SLOTS, 8, 1, 64), rnd(SLOTS, 8, MAX_LEN, 64),
          rnd(SLOTS, 8, MAX_LEN, 64), bias_b, False), F32_TOL),
        ("c_prefill_kv", "B4 H8 T127 D64 f32 causal+padding bias",
         (rnd(4, 8, t, 64), rnd(4, 8, t, 64), rnd(4, 8, t, 64), bias_c,
          False), F32_TOL),
        ("d_causal_bf16", "B2 H8 T256 D64 bf16 causal",
         (rnd(2, 8, 256, 64, dtype=bf), rnd(2, 8, 256, 64, dtype=bf),
          rnd(2, 8, 256, 64, dtype=bf), None, True), BF16_TOL),
        ("e_ragged_causal", "B2 H4 Tq100 Tk300 D32 f32 causal",
         (rnd(2, 4, 100, 32), rnd(2, 4, 300, 32), rnd(2, 4, 300, 32), None,
          True), F32_TOL),
        ("f_train", "B8 H8 T2048 D64 bf16 causal (training)",
         (rnd(8, 8, 2048, 64, dtype=bf), rnd(8, 8, 2048, 64, dtype=bf),
          rnd(8, 8, 2048, 64, dtype=bf), None, True), BF16_TOL),
        ("g_bias_bf16", "B2 H8 T256 D64 bf16 padded LM causal+padding bias",
         (rnd(2, 8, 256, 64, dtype=bf), rnd(2, 8, 256, 64, dtype=bf),
          rnd(2, 8, 256, 64, dtype=bf), bias_g, False), BF16_TOL),
        ("h_ragged_bf16", "B2 H4 Tq100 Tk300 D40 bf16 causal",
         (rnd(2, 4, 100, 40, dtype=bf), rnd(2, 4, 300, 40, dtype=bf),
          rnd(2, 4, 300, 40, dtype=bf), None, True), BF16_TOL),
        ("i_d36_bf16", "B2 H4 Tq100 Tk300 D36 bf16 causal (unaligned)",
         (rnd(2, 4, 100, 36, dtype=bf), rnd(2, 4, 300, 36, dtype=bf),
          rnd(2, 4, 300, 36, dtype=bf), None, True), BF16_TOL),
        ("j_decode_bf16", "S16 H8 Tq1 Tk512 D64 bf16 per-slot bias",
         (rnd(SLOTS, 8, 1, 64, dtype=bf), rnd(SLOTS, 8, MAX_LEN, 64, dtype=bf),
          rnd(SLOTS, 8, MAX_LEN, 64, dtype=bf), bias_b, False), BF16_TOL),
    ]


def _sdpa_mask(q, k, bias, causal):
    """The same additive mask for scaled_dot_product_attention."""
    tq, tk = q.shape[2], k.shape[2]
    mask = None if bias is None else bias.to(q.dtype)
    if causal:
        tri = torch.ones((tq, tk), dtype=torch.bool,
                         device=q.device).tril(tk - tq)
        c = torch.where(tri, 0.0, -1e9).to(q.dtype)
        mask = c if mask is None else mask + c
    return mask


# bf16 #1 is held as #5's state is (partial_state_held): within BF16_TOL,
# and by the bias of its error within PARTIAL_BF16_BIAS, where the call has
# at least FWD_BIAS_ROWS rows that see a key.  The tensor-core route rounds
# P to bf16 at each 64-key tile's running max, the plain version at the
# whole row's, so most entries differ by rounding noise of either sign, and
# only the sign of the error shows a truncating cast (-1.1e-3 to -2e-3, a
# CPU model, tests/test_torch_kernel_design.py).  The bias of the noise
# falls with the square root of the rows: at the 128 rows of a pooled
# decode the model reads up to 3.8e-4 for P rounded to nearest, so there
# BF16_TOL holds alone.  A row that sees no key is uniform over the keys,
# which the kernel sums exactly and the plain version through 1/Tk rounded
# to bf16: a bias of its own, so such rows are left out of the bias
FWD_BIAS_ROWS = 4096


def seen_rows(tq: int, tk: int, causal: bool):
    """[Tq] bool, the rows that see a key under the end-aligned causal
    mask; None when every row does."""
    if not causal or tk >= tq:
        return None
    return torch.arange(tq) + (tk - tq) >= 0


def seen_bias(got, want, seen=None):
    """(the bias of #1's error, state_bias, on the rows ``seen`` picks, the
    number of those rows)."""
    if seen is not None:
        seen = seen.to(got.device)
        got, want = got[..., seen, :], want[..., seen, :]
    return state_bias(got, want), got[..., 0].numel()


def fwd_held(got, want, seen=None):
    """(max abs err, entries that differ, held) of #1's output [B, H, Tq,
    D] by the rule above; ``seen`` (seen_rows) picks the rows the bias is
    read on."""
    if want.dtype != torch.bfloat16:
        return _close(got, want, F32_TOL)
    err, differ, ok = _close(got, want, BF16_TOL)
    bias, rows = seen_bias(got, want, seen)
    if rows >= FWD_BIAS_ROWS:
        ok = ok and abs(bias) <= PARTIAL_BF16_BIAS
    return err, differ, ok


def phase_kernel_checks(rates):
    """#1 through dot_product_attention against plain_attention at every
    shape of _inputs(), with the route each call took; times beside the
    plain version's, SDPA's and the bound, and for the tensor-core rows
    the scalar route's time on the same inputs and (at the training
    shape) the device split."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention_kernels as ak
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    with torch.no_grad():
        for key, desc, (q, k, v, bias, causal), tol in _inputs(gen):
            routes = dict(ak.flash_attention_fwd.routes)
            out = ak.dot_product_attention(q, k, v, bias, causal=causal)
            ref = ak.plain_attention(q, k, v, bias, causal=causal)
            torch.cuda.synchronize()
            route = ak.fwd_route(q.dtype, ak.rows_aligned(q, k, v))
            routes[route] += 1
            if ak.flash_attention_fwd.routes != routes:
                raise RuntimeError(f"{key}: the call took the routes "
                                   f"{ak.flash_attention_fwd.routes}, not "
                                   f"{routes}")
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{key}: kernel output is not finite")
            seen = seen_rows(q.shape[2], k.shape[2], causal)
            err, differ, ok = fwd_held(out, ref, seen)
            bias_err = (seen_bias(out, ref, seen)[0]
                        if q.dtype == torch.bfloat16 else None)
            if not ok:
                raise RuntimeError(f"{key}: kernel disagrees with the plain "
                                   f"version (max abs err {err:.3e}, error "
                                   f"bias {bias_err}, tolerance {tol}, bias "
                                   f"within {PARTIAL_BF16_BIAS:.3e})")
            # the same mask: causal self-attention as is_causal (SDPA's
            # flash path), any other as an additive mask
            lib = (dict(is_causal=True) if bias is None and causal
                   and q.shape[2] == k.shape[2]
                   else dict(attn_mask=_sdpa_mask(q, k, bias, causal)))
            cfg = (q.shape[-1] ** -0.5, causal, k.shape[2] - q.shape[2])
            row = {
                "shape": key, "what": desc, "route": route,
                "max_abs_err": err, "entries_differ": differ,
                "error_bias": bias_err,
                "ms": time_ms(lambda: ak.dot_product_attention(
                    q, k, v, bias, causal=causal), flush),
                "plain_ms": time_ms(lambda: ak.plain_attention(
                    q, k, v, bias, causal=causal), flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, **lib), flush),
            }
            if route == "tensor_core":
                # the scalar template on the same inputs: the kernel this
                # route replaced, timed in the same run
                row["scalar_ms"] = time_ms(lambda: ak._launch_fwd(
                    q, k, v, bias, *cfg, "scalar"), flush)
            if key == "f_train":
                row["device_split_ms"] = device_split(
                    lambda: ak.dot_product_attention(q, k, v, bias,
                                                     causal=causal))
            row["bound_ms"], row["bound_by"] = bound(q, k, v, bias, causal,
                                                     rates)
            results.append(row)
            extra = "" if bias_err is None else f" bias {bias_err:+.3e}"
            scalar = ("" if "scalar_ms" not in row
                      else f"  scalar_ms {row['scalar_ms']:.5f}")
            print(f"kernel {key:16s} {desc:48s} route {route:11s} "
                  f"max_abs_err {err:.3e}{extra}  kernel_ms "
                  f"{row['ms']:.5f}{scalar}  plain_ms "
                  f"{row['plain_ms']:.5f}  library_ms "
                  f"{row['library_ms']:.5f}  bound_ms "
                  f"{row['bound_ms']:.5f} ({row['bound_by']})"
                  + _split_text(row))
    return results


# ---------------------------------------------------------------------------
# 4. the backward kernels against their plain versions
# ---------------------------------------------------------------------------

# f32: sums of up to 2048 products, where cuBLAS may take another order.
# bf16 dQ (and the ring's #6 and #7) must agree bit for bit (tolerance
# None): kernel and plain version round P and dS to bf16 at the same
# points and sum the same products in one f32 FMA chain each.  The one
# exception is a row whose dS = P * (dP - Δ) cancels to rounding noise (a
# row that sees a single key): there cuBLAS may sum a one-column dP in
# another order, and an entry is held within bwd_floors' rounding floor,
# which elsewhere stays near 1% of an ulp of the largest entry.  A
# tolerance of a few ulps could not see a missing
# cast: one moves about 40% of the entries, each by at most one ulp of the
# largest (chip_gate_controls.py shows this check refusing such kernels).
# bf16 dK/dV runs on the tensor cores: s = q.k and dP = dO.v are summed in
# another order than the plain version's f32 FMA chain, so now and then a
# P or dS lands on the other side of a bf16 rounding point, and the
# entries it feeds move by one ulp of that operand times an entry of dO or
# Q.  So each entry is held within one bf16 ulp of the plain version's, or
# one ulp of the output's largest entry, and at most 1% of the entries
# may differ at all (chip_gate_controls.py reads 0.15% differing at the
# training shape, the worst at a quarter of an ulp of the largest entry,
# and a cast dropped or cut short moving two thirds of the entries).  One
# P or dS on the other neighbour moves a whole key row of D entries, so
# where Tk < 100 the share is one key row of each head, 1/Tk: at Tk 1
# (t_d8_tiny_bf16) every dK entry is dS times Q, and dS cancels to
# rounding noise, held by the same floor
F32_BWD_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_BF16_SHARE = 0.01
BWD_RUNS = 15                      # timed runs per kernel (median)
# flops per visible (query, key) pair: 2·D for each product
BWD_PRODUCTS = {"dq": 3, "dkv": 4, "dbias": 2}


def _bwd_inputs(gen):
    """The backward shapes, as (key, what, (q, k, v), bias, causal,
    bias needs a gradient): (t) is the training path's, and the (t_*)
    rows take bf16 through #2's and #3's tensor-core routes at their
    edges: a bias,
    ragged causal tq != tk, D 8, 16, 32 and 128, rows that see no key, a
    one-key output of 48 entries; (v)
    launches dBias with a learnable bias; (w) and (x) are ragged and
    end-aligned, (x) with rows that see no key; (y) has a constant mask."""
    dev = "cuda"

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def qkv(b, h, tq, tk, d, dtype=torch.float32):
        return rnd(b, h, tq, d, dtype=dtype), rnd(b, h, tk, d, dtype=dtype), \
            rnd(b, h, tk, d, dtype=dtype)

    t = 127
    lens = torch.tensor([127, 100, 9, 64], device=dev)
    pad = torch.arange(t, device=dev)[None, :] >= lens[:, None]
    tri = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    bias_y = (torch.where(tri, 0.0, -1e9)[None, None]
              + torch.where(pad, -1e9, 0.0)[:, None, None, :])
    bf = torch.bfloat16
    return [
        ("t_train", "B8 H8 T2048 D64 bf16 causal",
         qkv(8, 8, 2048, 2048, 64, bf), None, True, False),
        ("t_bias_bf16", "B2 H8 T256 D64 bf16 bias [B,1,T,T]",
         qkv(2, 8, 256, 256, 64, bf), rnd(2, 1, 256, 256), False, False),
        ("t_ragged_bf16", "B2 H4 Tq100 Tk300 D32 bf16 causal",
         qkv(2, 4, 100, 300, 32, bf), None, True, False),
        ("t_no_key_bf16", "B2 H4 Tq300 Tk100 D32 bf16 causal",
         qkv(2, 4, 300, 100, 32, bf), None, True, False),
        ("t_d128_bf16", "B2 H4 Tq200 Tk250 D128 bf16 causal",
         qkv(2, 4, 200, 250, 128, bf), None, True, False),
        ("u_causal", "B2 H8 T512 D64 f32 causal",
         qkv(2, 8, 512, 512, 64), None, True, False),
        ("v_bias_b1tt", "B2 H8 T256 D64 f32 learnable bias [B,1,T,T]",
         qkv(2, 8, 256, 256, 64), rnd(2, 1, 256, 256), False, True),
        ("v_bias_tt", "B2 H8 T256 D64 f32 learnable bias [T,T]",
         qkv(2, 8, 256, 256, 64), rnd(256, 256), False, True),
        ("w_ragged", "B2 H4 Tq100 Tk300 D32 f32 causal",
         qkv(2, 4, 100, 300, 32), None, True, False),
        ("x_no_key_rows", "B2 H4 Tq300 Tk100 D32 f32 causal",
         qkv(2, 4, 300, 100, 32), None, True, False),
        ("y_const_mask", "B4 H8 T127 D64 f32 causal+padding bias",
         qkv(4, 8, t, t, 64), bias_y, False, False),
        ("t_d8_tiny_bf16", "B3 H2 Tq5 Tk1 D8 bf16 causal",
         qkv(3, 2, 5, 1, 8, bf), None, True, False),
        ("t_d8_bf16", "B2 H8 T512 D8 bf16 causal",
         qkv(2, 8, 512, 512, 8, bf), None, True, False),
        ("t_d16_bf16", "B2 H8 Tq384 Tk512 D16 bf16 causal",
         qkv(2, 8, 384, 512, 16, bf), None, True, False),
    ]


def bwd_bound(kernel, q, k, bias, causal, rates):
    """Least device time for one backward kernel: inputs (q, k, v, dO,
    lse, Δ, bias) read once, its outputs written once, and 2·D flops
    per visible pair for each of its products."""
    mem_rate, f32_rate, bf16_rate = rates
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qd = q.numel() * q.element_size()
    kd = k.numel() * k.element_size()
    nbytes = 2 * qd + 2 * kd + 2 * b * h * tq * 4
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    nbytes += {"dq": qd, "dkv": 2 * kd, "dbias": b * h * tq * tk * 4}[kernel]
    flops = 2 * d * BWD_PRODUCTS[kernel] * b * h * _visible_pairs(tq, tk,
                                                                   causal)
    peak = bf16_rate if q.dtype == torch.bfloat16 else f32_rate
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _close(got, want, tol):
    """(max abs err, entries that differ, agrees): within ``tol``, or
    equal bit for bit where ``tol`` is None."""
    err = float((got.float() - want.float()).abs().max())
    differ = int((got != want).sum())
    if tol is None:
        return err, differ, differ == 0
    return err, differ, bool(torch.allclose(got.float(), want.float(),
                                            **tol))


def _bf16_ulp(x):
    """One bf16 ulp at the magnitude of each entry of ``x`` (f32)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def bwd_floors(q, k, v, bias, do, lse, delta, *, scale, causal=False,
               causal_offset=0):
    """Per-entry floors (f32) for bf16 (dQ, dK, dV): how far f32 rounding
    in the sums s = q·k and dP = dO·v, taken in another order, moves
    them.  Each sum is held to 2^-22 (four f32 ulps) of the sum of its
    products' magnitudes; that goes through P = exp(s − lse) and dS =
    P·(dP − Δ) into the outputs, doubled for the bf16 casts.  Where the
    entries carry signal it stays near 1% of an ulp of the largest entry
    or below; it decides only where dP − Δ cancels to rounding noise, as
    on a row that sees a single key (P = 1 and dO·v = Δ in exact
    arithmetic: the plain version may read 0 there, and cuBLAS sums its
    one-column dP in another order than at wider shapes)."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    b, h, tq, _ = q.shape
    gamma = 2.0 ** -22
    p, _ = ak._p_and_ds(q, k, v, bias, do, lse, delta, scale, causal,
                        causal_offset)
    qa, ka, va, da = (x.float().abs() for x in (q, k, v, do))
    e_p = p * (gamma * scale) * torch.matmul(qa, ka.transpose(-1, -2))
    a = torch.matmul(da, va.transpose(-1, -2)) \
        + delta.abs().reshape(b, h, tq, 1)
    e_ds = (p * gamma + e_p) * a
    return (2 * scale * torch.matmul(e_ds, ka),
            2 * scale * torch.matmul(e_ds.transpose(-1, -2), qa),
            2 * torch.matmul(e_p.transpose(-1, -2), da))


def bwd_held(kernel, got, want, floor=None):
    """(max abs err, entries that differ, held) of one output of backward
    kernel ``kernel`` ("dq", "dkv" or "dbias"): f32 within F32_BWD_TOL;
    bf16 dQ and dK/dV by the tensor-core rule: each entry within one bf16
    ulp of itself or of the largest entry, at most max(1%, one row a head)
    of the entries differing (1/Tq for dQ, 1/Tk for dK and dV); bf16 dS
    (dBias) bit for bit.  Where a ``floor`` (bwd_floors) is given, an
    entry within it also holds."""
    if want.dtype == torch.float32:
        return _close(got, want, F32_BWD_TOL)
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = torch.zeros_like(w) if floor is None else floor
    share = 1.0
    if kernel in ("dq", "dkv"):
        bound = torch.maximum(bound, torch.maximum(
            _bf16_ulp(w), _bf16_ulp(w.abs().max())))
        share = max(BWD_BF16_SHARE, 1 / want.shape[-2])
    differ = int((got != want).sum())
    ok = bool((diff <= bound).all()) and differ <= share * want.numel()
    return float(diff.max()), differ, ok


def bwd_rule(kernel, dtype):
    """The rule bwd_held holds an output of ``kernel`` in ``dtype`` to."""
    if dtype == torch.float32:
        return f"f32 {F32_BWD_TOL}"
    if kernel in ("dq", "dkv"):
        return (f"bf16 tensor cores: one ulp of the entry or of the largest "
                f"or the rounding floor, at most {BWD_BF16_SHARE:.0%} (or "
                f"one row a head, 1/T{'q' if kernel == 'dq' else 'k'}) "
                f"differing")
    return "bit for bit, or within the rounding floor"


def phase_bwd_kernel_checks(rates):
    """dQ, dK/dV and dBias against their plain versions on the same q, k,
    v, bias, dO and the forward kernel's lse; two launches of each must
    give the same bits; times beside the plain version's, the library's
    backward and the bound."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention_kernels as ak
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    kernels = {"dq": (ak.flash_attention_dq, ak.plain_attention_dq),
               "dkv": (ak.flash_attention_dkv, ak.plain_attention_dkv),
               "dbias": (ak.flash_attention_dbias, ak.plain_attention_dbias)}
    results = []
    for key, desc, (q, k, v), bias, causal, learnable in _bwd_inputs(gen):
        t0 = time.perf_counter()
        d, tq, tk = q.shape[-1], q.shape[2], k.shape[2]
        cfg = dict(scale=d ** -0.5, causal=causal, causal_offset=tk - tq)
        with torch.no_grad():
            out, lse = ak.flash_attention_fwd(q, k, v, bias, **cfg)
            do = torch.randn(out.shape, generator=gen,
                             device="cuda").to(q.dtype)
            delta = ak.attention_delta(out, do)
        args = (q, k, v, bias, do, lse, delta)
        all_floors = (bwd_floors(*args, **cfg) if q.dtype == torch.bfloat16
                      else (None,) * 3)
        names = ["dq", "dkv"] + (["dbias"] if learnable else [])
        # the library yardstick: one backward of SDPA for dq, dk, dv (and
        # the mask's gradient when the bias is learnable) together
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        if bias is None and causal and tq == tk:
            lib_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
        else:
            mask = _sdpa_mask(q, k, bias, causal)
            if learnable:
                mask = mask.detach().requires_grad_()
            lib_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     attn_mask=mask)
        lib_inputs = [qg, kg, vg] + ([mask] if learnable else [])
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_inputs, do, retain_graph=True), flush,
            runs=BWD_RUNS, warmup=2)
        for name in names:
            kernel, plain = kernels[name]
            with torch.no_grad():
                got = kernel(*args, **cfg)
                again = kernel(*args, **cfg)
                want = plain(*args, **cfg)
            torch.cuda.synchronize()
            got, again, want = ([x] if torch.is_tensor(x) else list(x)
                                for x in (got, again, want))
            if not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError(f"{name} at {key}: output not finite")
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise RuntimeError(f"{name} at {key}: two launches differ")
            floors = {"dq": all_floors[:1], "dkv": all_floors[1:]}.get(
                name, (None,) * len(got))
            checks = [bwd_held(name, g, w, f)
                      for g, w, f in zip(got, want, floors)]
            err = max(e for e, _, _ in checks)
            differ = sum(n for _, n, _ in checks)
            if not all(ok for _, _, ok in checks):
                raise RuntimeError(
                    f"{name} at {key}: kernel disagrees with the plain "
                    f"version (max abs err {err:.3e}, differing entries "
                    f"{[n for _, n, _ in checks]} of "
                    f"{[g.numel() for g in got]}; "
                    f"{bwd_rule(name, q.dtype)})")
            with torch.no_grad():
                row = {
                    "kernel": name, "shape": key, "what": desc,
                    "max_abs_err": err, "entries_differ": differ,
                    "share_differ": differ / sum(g.numel() for g in got),
                    "rule": bwd_rule(name, q.dtype),
                    "route": {"dq": ak.dq_route, "dkv": ak.dkv_route}.get(
                        name, lambda _: "scalar")(q.dtype),
                    "bitwise_repeatable": True,
                    "ms": time_ms(lambda: kernel(*args, **cfg), flush,
                                  runs=BWD_RUNS, warmup=2),
                    "plain_ms": time_ms(lambda: plain(*args, **cfg), flush,
                                        runs=BWD_RUNS, warmup=2),
                    "library_ms": library_ms,
                }
            row["bound_ms"], row["bound_by"] = bwd_bound(
                name, q, k, bias, causal, rates)
            if name == "dq" and row["route"] == "tensor_core":
                row["device_split_ms"] = device_split(
                    lambda: kernel(*args, **cfg))
            results.append(row)
            print(f"bwd {name:5s} {key:13s} {desc:44s} {row['route']} "
                  f"max_abs_err {err:.3e} ({differ} differ) repeatable  "
                  f"kernel_ms {row['ms']:.5f}  "
                  f"plain_ms {row['plain_ms']:.5f}  library_ms "
                  f"{library_ms:.5f}  bound_ms {row['bound_ms']:.5f} "
                  f"({row['bound_by']})" + _split_text(row))
        if not learnable:
            print(f"bwd dbias {key:13s} not launched: the bias is "
                  f"{'absent' if bias is None else 'a constant mask'}")
        print(f"  ({key}: {time.perf_counter() - t0:.1f} s)")
    return results


# ---------------------------------------------------------------------------
# 4b. the ring-attention kernels #5-#7 against their plain versions
# ---------------------------------------------------------------------------

SP_SHARDS = 4                      # the seq mesh of the SP training phase
SP_CHUNK = 2048 // SP_SHARDS       # Tc of one shard at T2048
# #5 is held as #1 is: its normalised state acc / l to F32_TOL or
# BF16_TOL, m and l (unrounded f32 sums) to F32_TOL.  In bf16 it merges
# 64-key tiles with a running max, the plain version the whole chunk at
# once, so P is rounded to bf16 at other scales and acc / l moves by
# rounding noise of either sign, well inside BF16_TOL.  So would a P cut
# short instead of rounded (a truncating cast), which shrinks every term
# of P.V by about 2^-9 of itself.  So bf16 acc / l is held besides by its
# bias, the error's projection on the plain value, sum (got - want) * want
# / sum want^2: near 1e-6 for P rounded to nearest, near -1.5e-3 for P
# truncated (a CPU model of the tiled merge,
# tests/test_torch_kernel_design.py), against PARTIAL_BF16_BIAS.
# #6 and #7 in bf16 run on the tensor cores with dO (and #7's P) split into
# three bf16 pieces (dq_partial_route, dkv_partial_route): their sums run
# in another order, so #6's dQ and #7's dK (dS rounded to bf16 before dS·K
# and dSᵀ·Q) are held by partial_ulp_held: each entry within one bf16 ulp
# of the plain entry or of the largest, and at most max(1%, one row a
# head) of the entries differing once rounded to bf16, the dtype the ring
# casts the summed dQ and dK to: another order of s and dP now and then
# puts a dS on its other bf16 neighbour, which moves a row of the f32
# output by a fraction of an ulp of the largest entry, where dO in one
# bf16 piece or dS truncated moves 40-66% of the entries (a CPU model of
# #6, tests/test_torch_kernel_design.py).  #7's dV (Pᵀ·dO with both in
# f32): its largest error against dkv_partial_exact_dv (every step in f64
# from the same inputs), relative to the largest entry, at most
# DV_F32_MULTIPLE times the plain version's own (at least one f32
# rounding, 2^-24): P or dO rounded to bf16 moves it by about 2^-9
# (chip_gate_controls.py).  F32_BWD_TOL for f32.
PARTIAL_BF16_BIAS = 2.0 ** -12
DV_F32_MULTIPLE = 4
PARTIAL_RUNS = 15


def _partial_problems():
    """(key, what, (b, h, tq, tk, d), q_offset, k_offset, causal, dtype,
    state carried): the SP path's chunk pairs in f32 and bf16, and a
    ragged pair whose offsets are not tile multiples."""
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tc = SP_CHUNK
        shape = (8, 8, tc, tc, 64)
        rows += [
            (f"diag_{tag}", f"B8 H8 Tc{tc} D64 {tag} diagonal 1024/1024",
             shape, 2 * tc, 2 * tc, True, dtype, False),
            (f"offdiag_{tag}", f"B8 H8 Tc{tc} D64 {tag} off-diagonal "
             f"1536/512", shape, 3 * tc, tc, True, dtype, True),
            (f"noncausal_{tag}", f"B8 H8 Tc{tc} D64 {tag} non-causal",
             shape, tc, 3 * tc, False, dtype, True),
            (f"ragged_{tag}", f"B2 H4 Tc200 D40 {tag} 200/0 causal",
             (2, 4, 200, 200, 40), 200, 0, True, dtype, True),
        ]
    return rows


def _partial_pairs(tq, tk, q_offset, k_offset, causal) -> int:
    """Visible (query, key) pairs of one chunk pair: global row q_offset+i
    sees global key k_offset+j when it is not later."""
    if not causal:
        return tq * tk
    seen = np.arange(tq) + (q_offset - k_offset) + 1
    return int(np.clip(seen, 0, tk).sum())


# products per visible pair, as (bf16-able, f32): #5 q·k and P·V; #6 q·k,
# dS·K and dP = dO·v (dO is f32); #7 q·k, dSᵀ·Q, dP and Pᵀ·dO (P and dO
# f32).  A product of two bf16 operands runs at the bf16 rate.  The bf16
# routes of #6 and #7 issue their f32 products as bf16 pieces, 3 for dP
# and 6 for #7's dV (SPLIT_PRODUCTS): the least time for that work counts
# them all at the bf16 rate, not the f32 products at the f32 rate.
PARTIAL_PRODUCTS = {"partial": (2, 0), "dq_partial": (2, 1),
                    "dkv_partial": (2, 2)}
SPLIT_PRODUCTS = {"dq_partial": 5, "dkv_partial": 11}


def partial_bound(kernel, shape, q_offset, k_offset, causal, dtype, rates):
    """Least device time of one partial kernel call: its inputs (q, k, v,
    and the f32 state, or dO, lse and Δ) read once and its f32 outputs
    written once over the memory rate, against 2·D flops per visible pair
    for each product at the peak rate of its operands' type, summed (for
    #7 in bf16, each of the split route's bf16 products at the bf16
    rate)."""
    mem_rate, f32_rate, bf16_rate = rates
    b, h, tq, tk, d = shape
    size = 2 if dtype == torch.bfloat16 else 4
    qkv = (b * h * tq * d + 2 * b * h * tk * d) * size
    rows_f32 = b * h * tq * 4
    if kernel == "partial":   # acc, m, l in and out
        nbytes = qkv + 2 * (b * h * tq * d * 4 + 2 * rows_f32)
    else:                     # dO (f32), lse, Δ in; dq or dk, dv (f32) out
        out = b * h * tq * d * 4 if kernel == "dq_partial" \
            else 2 * b * h * tk * d * 4
        nbytes = qkv + b * h * tq * d * 4 + 2 * rows_f32 + out
    pairs = b * h * _partial_pairs(tq, tk, q_offset, k_offset, causal)
    if dtype == torch.bfloat16 and kernel in SPLIT_PRODUCTS:
        per_pair = SPLIT_PRODUCTS[kernel] / bf16_rate
    else:
        low, full = PARTIAL_PRODUCTS[kernel]
        low_rate = bf16_rate if dtype == torch.bfloat16 else f32_rate
        per_pair = low / low_rate + full / f32_rate
    t_ops = 2 * d * pairs * per_pair * 1e3
    t_bytes = nbytes / mem_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _sdpa_chunk_mask(tq, tk, q_offset, k_offset, causal, dtype):
    """SDPA's additive mask for the chunk pair: None when every pair is
    visible, else -1e9 where a global row may not see a global key."""
    if not causal or q_offset >= k_offset + tk - 1:
        return None
    rows = q_offset + torch.arange(tq, device="cuda")
    keys = k_offset + torch.arange(tk, device="cuda")
    return torch.where(rows[:, None] >= keys[None], 0.0, -1e9).to(dtype)


def partial_inputs(problem, gen):
    """(q, k, v, state (acc, m, l), dO f32, lse, Δ) of one chunk pair: the
    state is fresh, or carried from a plain merge of a previous chunk at
    the same rows (the diagonal one); lse and Δ are those of the rows
    after both merges."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    _, _, (b, h, tq, tk, d), q_off, k_off, causal, dtype, carried = problem

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(b, h, tq, d), rnd(b, h, tk, d), rnd(b, h, tk, d)
    state = (torch.zeros(b, h, tq, d, device="cuda"),
             torch.full((b, h, tq), ak.NEG_INF, device="cuda"),
             torch.zeros(b, h, tq, device="cuda"))
    scale = d ** -0.5
    with torch.no_grad():
        if carried:
            state = ak.plain_attention_partial(
                q, rnd(b, h, tq, d), rnd(b, h, tq, d), *state,
                q_offset=q_off, k_offset=q_off, scale=scale, causal=causal)
        acc, m, l = ak.plain_attention_partial(
            q, k, v, *state, q_offset=q_off, k_offset=k_off, scale=scale,
            causal=causal)
        out = (acc / l[..., None]).to(dtype)
        do = torch.randn(b, h, tq, d, generator=gen, device="cuda")
        lse = m + torch.log(l)
        delta = (do * out.float()).sum(-1)
    return q, k, v, state, do, lse, delta


def partial_calls(q, k, v, state, do, lse, delta):
    """{name: (kernel, plain version, arguments, library direction)} of
    #5-#7 on one chunk pair's inputs."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    return {
        "partial": (ak.flash_attention_partial, ak.plain_attention_partial,
                    (q, k, v, *state), "fwd"),
        "dq_partial": (ak.flash_attention_dq_partial,
                       ak.plain_attention_dq_partial,
                       (q, k, v, do, lse, delta), "bwd"),
        "dkv_partial": (ak.flash_attention_dkv_partial,
                        ak.plain_attention_dkv_partial,
                        (q, k, v, do, lse, delta), "bwd"),
    }


def partial_cfg(problem):
    _, _, shape, q_off, k_off, causal, _, _ = problem
    return dict(q_offset=q_off, k_offset=k_off, scale=shape[4] ** -0.5,
                causal=causal)


def partial_tols(name, problem):
    """The rule of each held output: #5's acc / l (and in bf16 its bias),
    m, l; #6's dq; #7's dk, dv."""
    dtype = problem[6]
    if name == "partial":
        state = (f"{BF16_TOL}, bias within {PARTIAL_BF16_BIAS:.3e}"
                 if dtype == torch.bfloat16 else F32_TOL)
        return [state, F32_TOL, F32_TOL]
    ulp_rule = (f"one bf16 ulp of the entry or the largest, at most "
                f"{BWD_BF16_SHARE:.0%} (or one row a head) differing in bf16")
    if name == "dkv_partial" and dtype == torch.bfloat16:
        return [ulp_rule, f"error against the f64 sum at most "
                f"{DV_F32_MULTIPLE}x the plain version's"]
    if dtype == torch.bfloat16:
        return [ulp_rule]
    return [F32_BWD_TOL] * (1 if name == "dq_partial" else 2)


def dkv_partial_exact_dv(q, k, v, do, lse, delta, *, q_offset, k_offset,
                         scale, causal=False):
    """#7's dV with every step in f64 from the same inputs: s = q·kᵀ·scale,
    -1e9 where a global row may not see a global key, P = exp(s − lse),
    dV = Pᵀ·dO.  The anchor the bf16 route's dV and the plain version's
    are both measured against."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if causal:
        rows = q_offset + torch.arange(q.shape[-2], device=q.device)
        keys = k_offset + torch.arange(k.shape[-2], device=q.device)
        s = s.masked_fill(rows[:, None] < keys[None, :], -1e9)
    p = torch.exp(s - lse.double()[..., None])
    return torch.matmul(p.transpose(-1, -2), do.double())


def dv_rel_err(got, exact):
    """The largest error of dV against its f64 anchor, relative to the
    anchor's largest entry."""
    return float((got.double() - exact).abs().max()
                 / exact.abs().max().clamp_min(1e-300))


def partial_ulp_held(got, want):
    """(max abs err, entries that differ, held) of #6's f32 dQ or #7's
    f32 dK in bf16 by the rule above: bwd_held's ulp rule on the f32
    entries, the share (max(1%, one row a head)) counted on their bf16
    roundings."""
    diff = (got - want).abs()
    ulp = torch.maximum(_bf16_ulp(want), _bf16_ulp(want.abs().max()))
    differ = int((got.to(torch.bfloat16) != want.to(torch.bfloat16)).sum())
    share = max(BWD_BF16_SHARE, 1 / want.shape[-2])
    return (float(diff.max()), differ,
            bool((diff <= ulp).all()) and differ <= share * want.numel())


def dkv_partial_held(got, want, exact_dv):
    """[(max abs err, entries that differ, held) of dK, of dV] and the dV
    readings {dv_err, dv_plain_err} of #7 in bf16, by the rule above:
    dK by partial_ulp_held, dV against the f64 anchor."""
    (gk, gv), (wk, wv) = got, want
    dk = partial_ulp_held(gk, wk)
    err, plain_err = dv_rel_err(gv, exact_dv), dv_rel_err(wv, exact_dv)
    dv = (float((gv - wv).abs().max()), int((gv != wv).sum()),
          err <= DV_F32_MULTIPLE * max(plain_err, 2.0 ** -24))
    return [dk, dv], {"dv_err": err, "dv_plain_err": plain_err}


def state_bias(got, want):
    """The projection of the error of #5's normalised state on the plain
    value: sum (got - want) * want / sum want^2."""
    g, w = got.double(), want.double()
    return float(((g - w) * w).sum() / (w * w).sum().clamp_min(1e-300))


def partial_state_held(got, want, dtype):
    """(max abs err, entries that differ, held) of #5's normalised state
    acc / l: within the dtype's tolerance, and in bf16 with a bias within
    PARTIAL_BF16_BIAS."""
    err, differ, ok = _close(got, want, BF16_TOL if dtype == torch.bfloat16
                             else F32_TOL)
    if dtype == torch.bfloat16:
        ok = ok and abs(state_bias(got, want)) <= PARTIAL_BF16_BIAS
    return err, differ, ok


def check_partial(name, calls, problem):
    """One partial kernel against its plain version: ([(max abs err,
    entries that differ, held)] per output, two launches equal bit for
    bit, readings).  #5 is held on its normalised state acc / l
    (partial_state_held), and m and l, with {"state_bias": ...}; #6 in
    bf16 by partial_ulp_held; #7 in bf16 by dkv_partial_held, with its dV
    readings."""
    kernel, plain, args, _ = calls[name]
    cfg = partial_cfg(problem)
    with torch.no_grad():
        got, again, want = [list(out) if isinstance(out, tuple) else [out]
                            for out in (f(*args, **cfg)
                                        for f in (kernel, kernel, plain))]
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise RuntimeError(f"{name} at {problem[0]}: output not finite")
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    if name == "dkv_partial" and problem[6] == torch.bfloat16:
        with torch.no_grad():
            exact = dkv_partial_exact_dv(*args, **cfg)
        checks, extra = dkv_partial_held(got, want, exact)
        return checks, same, extra
    if name == "dq_partial" and problem[6] == torch.bfloat16:
        return [partial_ulp_held(got[0], want[0])], same, {}
    if name != "partial":
        return [_close(g, w, tol) for g, w, tol in
                zip(got, want, partial_tols(name, problem))], same, {}
    state, ref = got[0] / got[2][..., None], want[0] / want[2][..., None]
    checks = [partial_state_held(state, ref, problem[6]),
              *(_close(g, w, F32_TOL) for g, w in zip(got[1:], want[1:]))]
    return checks, same, {"state_bias": state_bias(state, ref)}


def _partial_scalar(name):
    """Partial kernel ``name`` (#6's "dq_partial" or #7's "dkv_partial")
    by its scalar template whatever the dtype (uncounted): the kernel the
    bf16 tensor-core route replaced, timed beside it."""
    from bigdl_tpu_torch.ops import attention_kernels as ak

    def run(q, k, v, do, lse, delta, **cfg):
        out0 = torch.empty((k if name == "dkv_partial" else q).shape,
                           dtype=torch.float32, device=q.device)
        out1 = (torch.empty(v.shape, dtype=torch.float32, device=v.device)
                if name == "dkv_partial" else None)
        ak._launch_partial_bwd(f"flash_attention_{name}", q, k, v, do, lse,
                               delta, out0, out1, cfg["scale"],
                               cfg["causal"], cfg["q_offset"],
                               cfg["k_offset"], "scalar")
        return out0 if out1 is None else (out0, out1)
    return run


def phase_partial_kernel_checks(rates):
    """#5, #6 and #7 against their plain versions at every problem of
    _partial_problems(); two launches of each must give the same bits;
    times beside the plain version's, SDPA's on the chunk pair and the
    bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    from bigdl_tpu_torch.ops import attention_kernels as ak
    results = []
    for problem in _partial_problems():
        key, what, shape, q_off, k_off, causal, dtype, _ = problem
        t0 = time.perf_counter()
        q, k, v, state, do, lse, delta = partial_inputs(problem, gen)
        cfg = partial_cfg(problem)
        mask = _sdpa_chunk_mask(shape[2], shape[3], q_off, k_off, causal,
                                dtype)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        library = {
            "fwd": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush, runs=PARTIAL_RUNS,
                warmup=2),
            "bwd": time_ms(lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do.to(dtype), retain_graph=True),
                flush, runs=PARTIAL_RUNS, warmup=2)}
        calls = partial_calls(q, k, v, state, do, lse, delta)
        for name, (kernel, plain, args, direction) in calls.items():
            checks, same, extra = check_partial(name, calls, problem)
            if not same:
                raise RuntimeError(f"{name} at {key}: two launches differ")
            err = max(e for e, _, _ in checks)
            differ = sum(n for _, n, _ in checks)
            if not all(ok for _, _, ok in checks):
                raise RuntimeError(
                    f"{name} at {key}: kernel disagrees with the plain "
                    f"version (max abs err {err:.3e}, {differ} entries "
                    f"differ, tolerances {partial_tols(name, problem)})")
            with torch.no_grad():
                route = {"partial": ak.partial_route(
                             dtype, ak.rows_aligned(q, k, v)),
                         "dq_partial": ak.dq_partial_route(
                             dtype, ak.rows_aligned(q, k, v, do)),
                         "dkv_partial": ak.dkv_partial_route(
                             dtype, ak.rows_aligned(q, k, v, do))}[name]
                row = {
                    "kernel": name, "shape": key, "what": what,
                    "route": route,
                    "max_abs_err": err, "entries_differ": differ, **extra,
                    "bitwise_repeatable": True,
                    "ms": time_ms(lambda: kernel(*args, **cfg), flush,
                                  runs=PARTIAL_RUNS, warmup=2),
                    "plain_ms": time_ms(lambda: plain(*args, **cfg), flush,
                                        runs=PARTIAL_RUNS, warmup=2),
                    "library_ms": library[direction],
                    "library": f"SDPA {direction} on the chunk pair (merges "
                               f"no carried state)",
                }
            row["bound_ms"], row["bound_by"] = partial_bound(
                name, shape, q_off, k_off, causal, dtype, rates)
            if row["route"] == "tensor_core":
                row["device_split_ms"] = device_split(
                    lambda: kernel(*args, **cfg))
                if name != "partial":
                    row["scalar_ms"] = time_ms(
                        lambda: _partial_scalar(name)(*args, **cfg), flush,
                        runs=PARTIAL_RUNS, warmup=2)
            results.append(row)
            bias = "".join(f" {n} {x:+.3e}" for n, x in extra.items())
            if "scalar_ms" in row:
                bias += f"  scalar_ms {row['scalar_ms']:.5f}"
            print(f"ring {name:11s} {key:14s} {what:44s} max_abs_err "
                  f"{err:.3e} ({differ} differ){bias} repeatable  kernel_ms "
                  f"{row['ms']:.5f}  plain_ms {row['plain_ms']:.5f}  "
                  f"library_ms {row['library_ms']:.5f}  bound_ms "
                  f"{row['bound_ms']:.5f} ({row['bound_by']})"
                  + _split_text(row))
        print(f"  ({key}: {time.perf_counter() - t0:.1f} s)")
        del q, k, v, state, do, lse, delta, qg, kg, vg, lib_out, calls
    return results


# ---------------------------------------------------------------------------
# 5. serving at full width
# ---------------------------------------------------------------------------

def _traffic():
    rng = np.random.default_rng(10)
    lens = np.concatenate([rng.integers(129, 449, 8),       # > one chunk
                           rng.integers(8, 129, N_REQUESTS - 8)])
    rng.shuffle(lens)
    prompts = [rng.integers(1, VOCAB + 1, int(n)).astype(np.int32)
               for n in lens]
    max_news = [int(min(rng.integers(16, 65), MAX_LEN - len(p)))
                for p in prompts]
    return prompts, max_news


def _solo_margin(lm, prompt, step):
    """Top-2 logit margin of a solo greedy decode at ``step``."""
    with torch.no_grad():
        p = lm._tokens(prompt)[None]
        caches = lm._prefill(p, lm.init_cache(1))
        tok = p[:, -1:]
        for t in range(step + 1):
            logits, caches = lm.decode_step(tok, len(prompt) - 1 + t, caches)
            masked = lm._mask_untrained_logit(logits)
            tok = masked.argmax(-1, keepdim=True) + 1
        top2 = masked[0].topk(2).values
        return float(top2[0] - top2[1])


def phase_serving(device: str = "cuda"):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import GenerationScheduler, ModelServer

    gen = torch.Generator().manual_seed(0)
    lm = TransformerLM(vocab_size=VOCAB, hidden_size=HIDDEN,
                       num_layers=LAYERS, num_heads=HEADS,
                       filter_size=FILTER, max_len=MAX_LEN,
                       generator=gen, device=device).eval()

    # the model on the card against its copy on the CPU (plain attention)
    import copy
    probe = np.random.default_rng(3).integers(1, VOCAB + 1, (2, 96))
    probe[1, 80:] = 0
    with torch.no_grad():
        on_card = lm(probe).cpu()
        on_cpu = copy.deepcopy(lm).to("cpu")(probe)
    if not torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4):
        raise RuntimeError(
            "forward logits on the card differ from the CPU reference: "
            f"max abs err {float((on_card - on_cpu).abs().max()):.3e}")
    print(f"forward: logits {tuple(on_card.shape)} on the card match the "
          f"CPU plain path (max abs err "
          f"{float((on_card - on_cpu).abs().max()):.3e})")

    prompts, max_news = _traffic()
    print(f"traffic: {len(prompts)} requests, prompt lengths "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} "
          f"({sum(len(p) > PREFILL_CHUNK for p in prompts)} over "
          f"{PREFILL_CHUNK}), max_new_tokens {min(max_news)}-{max(max_news)}")

    def new_server():
        return ModelServer(generator=GenerationScheduler(
            lm, slots=SLOTS, prefill_chunk=PREFILL_CHUNK,
            prefill_batch=PREFILL_BATCH, device=device), device=device)

    # warm-up (CUDA and cuBLAS initialisation) on a server of its own,
    # drained and shut down before the counts are reset
    with new_server() as warm:
        warm.submit_generate_many([prompts[0][:8], prompts[0]], 4,
                                  timeout=600)

    server = new_server()
    ttft = [None] * len(prompts)
    futs = []
    _zero_counts()
    t0 = time.perf_counter()
    try:
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            t_sub = time.perf_counter()

            def first(_tok, i=i, t_sub=t_sub):
                if ttft[i] is None:
                    ttft[i] = time.perf_counter() - t_sub
            futs.append(server.submit_generate_async(p, m, on_token=first))
        rows = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()   # drains: every dispatched step is read back
    counts = _read_counts()
    routes = _read_routes()
    launches = counts["flash_attention_fwd"]
    stats = server.generation_stats()

    calls = stats["prefill_calls"] + stats["decode_steps"]
    q = np.quantile(np.asarray(ttft, dtype=float), [0.5, 0.99])
    print(f"serving: {stats['tokens_emitted']} new tokens in {wall:.4f} s = "
          f"{stats['tokens_emitted'] / wall:.2f} tokens/s; TTFT p50 "
          f"{q[0]:.5f} s, p99 {q[1]:.5f} s; prefill calls "
          f"{stats['prefill_calls']}, decode steps "
          f"{stats['decode_steps']}; flash_attention_fwd launches "
          f"{launches}")
    # one attention call per layer in every prefill call and decode step
    if launches == 0 or launches != LAYERS * calls:
        raise RuntimeError(f"kernel launches {launches} != layers x "
                           f"(prefill calls + decode steps) = "
                           f"{LAYERS * calls}")
    # the f32 serving path keeps #1's scalar template
    _check_routes(routes, "flash_attention_fwd",
                  {"tensor_core": 0, "scalar": launches}, "f32 serving")

    differ = 0
    for i, (p, m, row) in enumerate(zip(prompts, max_news, rows)):
        if row.shape != (len(p) + m,) or not np.array_equal(row[:len(p)], p) \
                or not ((row[len(p):] >= 1) & (row[len(p):] <= VOCAB)).all():
            raise RuntimeError(f"request {i}: malformed row {row.shape}")
        solo = lm.generate(p[None], m)[0].cpu().numpy()
        if np.array_equal(solo, row):
            continue
        differ += 1
        step = int(np.flatnonzero(solo[len(p):] != row[len(p):])[0])
        margin = _solo_margin(lm, p, step)
        print(f"request {i}: served row differs from solo generate() at "
              f"new token {step}; solo top-2 logit margin {margin:.3e}")
        if margin >= NEAR_TIE:
            raise RuntimeError(f"request {i} diverges from solo generate() "
                               f"at a margin of {margin:.3e} (not a "
                               f"near-tie)")
    print(f"rows: {len(rows) - differ}/{len(rows)} served rows equal solo "
          f"generate() token for token; {differ} differ at a near-tie")
    return counts, routes


# ---------------------------------------------------------------------------
# 6-7. training at full width, and a step held against the CPU
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_ITERS, TRAIN_EPOCHS = 2048, 8, 5, 4
TRAIN_ARGV = ["--model", "transformer-lm", "--seq-len", str(TRAIN_SEQ),
              "-b", str(TRAIN_BATCH), "--hidden-size", str(HIDDEN),
              "--num-layers", str(LAYERS), "--num-heads", str(HEADS),
              "--vocab-size", str(VOCAB), "--bf16",
              "--iterations", str(TRAIN_ITERS),
              "--epochs", str(TRAIN_EPOCHS)]
# f32 card against CPU, one step: the loss is a mean over 4096 tokens
# (sums in another order: 1e-5 relative).  Each gradient is a sum over
# 4096 tokens and 2048 keys, through 6 layers, taken in another order by
# cuBLAS, the kernels and the CPU's BLAS; cancelling sums leave a few
# entries 1e-3 of their tensor's largest off.  So each tensor is held to
# 1e-3 in norm (||card - cpu|| / ||cpu||) and to 1e-2 of its largest
# entry.  The same step with the attention backward in bf16 reads about
# 2e-3 in norm, which the norm bound refuses (chip_gate_controls.py)
PARITY_BATCH, LOSS_RTOL, GRAD_NORM_REL, GRAD_MAX_REL = 2, 1e-5, 1e-3, 1e-2


def phase_training():
    """The port's perf training path at full width, bf16 compute.  Each
    call of #1-#3 is bracketed by CUDA events, so the last epoch's steps
    split into the three kernels and the rest."""
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.nn.attention import Attention
    from bigdl_tpu_torch.ops import attention_kernels as ak
    seen = set()

    def record_dtype(module, _inputs, output):
        if isinstance(module, Attention):
            seen.add(output.dtype)
    hook = torch.nn.modules.module.register_module_forward_hook(
        record_dtype)
    kernels = ak._KERNELS
    logs = {fn.__name__: [] for fn in kernels[:3]}
    ak._KERNELS = (*(_timed(fn, logs[fn.__name__]) for fn in kernels[:3]),
                   kernels[3])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        out, opt = perf.train(perf.parse_args(TRAIN_ARGV))
    finally:
        hook.remove()
        ak._KERNELS = kernels
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    routes = _read_routes()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = TRAIN_ITERS * TRAIN_EPOCHS
    losses = [loss for _, loss in opt.loss_history]
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (out["ms_per_iteration"] / 1e3)
    kernel_ms = {name: sum(s.elapsed_time(e) for s, e in
                           log[-LAYERS * TRAIN_ITERS:]) / TRAIN_ITERS
                 for name, log in logs.items()}
    rest_ms = out["ms_per_iteration"] - sum(kernel_ms.values())
    print(f"training: {json.dumps(out)}")
    print(f"training: {steps} steps in {wall:.3f} s; "
          f"{out['records_per_sec']} records/s, {tokens_s:.1f} tokens/s, "
          f"{out['ms_per_iteration']} ms/iteration (steady windows); "
          f"first window {out['compile_plus_first_window_s']} s; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; peak memory "
          f"{peak_gb:.3f} GiB; attention output dtypes "
          f"{sorted(str(d) for d in seen)}; launches {launches}; routes "
          f"{routes}")
    print("training: last epoch, device ms per step: "
          + ", ".join(f"{n} {t:.3f} ({LAYERS} launches)"
                      for n, t in kernel_ms.items())
          + f"; the rest {rest_ms:.3f}")
    if seen != {torch.bfloat16}:
        raise RuntimeError(f"the bf16 run's attention computed in {seen}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite or missing: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    want = LAYERS * steps
    if not (launches["flash_attention_fwd"]
            == launches["flash_attention_dq"]
            == launches["flash_attention_dkv"] == want):
        raise RuntimeError(f"launches {launches} != {LAYERS} layers x "
                           f"{steps} steps = {want} each")
    if launches["flash_attention_dbias"] != 0:
        raise RuntimeError("dBias launched on a path without a bias")
    # every bf16 forward, dQ and dK/dV launch of the path took the tensor
    # cores
    for name in DENSE_NAMES[:3]:
        _check_routes(routes, name, {"tensor_core": want, "scalar": 0},
                      "bf16 LM training")
    return dict(out, tokens_per_sec=tokens_s, steps=steps,
                first_loss=losses[0], last_loss=losses[-1],
                peak_memory_gib=peak_gb, launches=launches, routes=routes,
                kernel_ms_per_step=kernel_ms, rest_ms_per_step=rest_ms)


def grad_step(x, y):
    """``step(model, device, perturb=None) -> (loss, {name: gradient on
    the CPU})``: one train-mode forward and backward of the cross-entropy
    over the batch (x, y).  With ``perturb`` (a seed) each input moves by
    2^-23 of itself in a random direction: the step's own sensitivity."""
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    crit = CrossEntropyCriterion()

    def step(model, device, perturb=None):
        xs = x
        if perturb is not None:
            sign = np.random.default_rng(perturb).choice([-1, 1], x.shape)
            xs = x * (1 + sign * 2.0 ** -23).astype(np.float32)
        model.train()
        model.zero_grad(set_to_none=True)
        loss = crit(model(torch.as_tensor(xs, device=device)),
                    torch.as_tensor(y, device=device))
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu()
                                      for n, p in model.named_parameters()}
    return step


def parity_setup():
    """The full-width LM of the f32 parity step on the card, its CPU
    copy, and :func:`grad_step` over one fixed batch of PARITY_BATCH
    sequences."""
    import copy
    from bigdl_tpu_torch.examples.perf import FlatLM
    from bigdl_tpu_torch.models import TransformerLM
    lm = TransformerLM(VOCAB, HIDDEN, LAYERS, HEADS, 4 * HIDDEN, TRAIN_SEQ,
                       padded_inputs=False,
                       generator=torch.Generator().manual_seed(1),
                       device="cuda")
    on_card = FlatLM(lm)
    on_cpu = copy.deepcopy(on_card).to("cpu")
    rng = np.random.default_rng(4)
    x = rng.integers(1, VOCAB + 1, (PARITY_BATCH, TRAIN_SEQ))
    y = rng.integers(1, VOCAB + 1, (PARITY_BATCH * TRAIN_SEQ,))
    return on_card, on_cpu, grad_step(x, y)


def parity_report(card, cpu, label="train parity",
                  bounds=(LOSS_RTOL, GRAD_NORM_REL, GRAD_MAX_REL),
                  what=f"batch {PARITY_BATCH}, T{TRAIN_SEQ}",
                  sides=("card", "cpu")):
    """Hold a card step's ``(loss, grads)`` against the CPU's (or, with
    ``sides``, one step against another) and print the worst errors;
    returns (worst norm error, worst entry error, within ``bounds``: the
    loss's relative error, each gradient's norm error and its worst entry
    relative to its largest)."""
    loss_rtol, grad_norm_rel, grad_max_rel = bounds
    (loss_card, g_card), (loss_cpu, g_cpu) = card, cpu
    norm_rel = {n: float((g_card[n] - g_cpu[n]).norm()
                         / max(float(g_cpu[n].norm()), 1e-30))
                for n in g_cpu}
    max_rel = {n: float((g_card[n] - g_cpu[n]).abs().max()
                        / max(float(g_cpu[n].abs().max()), 1e-30))
               for n in g_cpu}
    worst_norm = max(norm_rel, key=norm_rel.get)
    worst_max = max(max_rel, key=max_rel.get)
    ok = (abs(loss_card - loss_cpu) <= loss_rtol * abs(loss_cpu)
          and norm_rel[worst_norm] <= grad_norm_rel
          and max_rel[worst_max] <= grad_max_rel)
    print(f"{label}: f32 step at {what}: loss "
          f"{sides[0]} {loss_card:.7f} {sides[1]} {loss_cpu:.7f}; over "
          f"{len(g_cpu)} "
          f"gradient tensors the worst norm error is "
          f"{norm_rel[worst_norm]:.3e} ({worst_norm}) and the worst entry "
          f"{max_rel[worst_max]:.3e} of its tensor's largest ({worst_max}); "
          f"{'within' if ok else 'BEYOND'} the bounds")
    return norm_rel[worst_norm], max_rel[worst_max], ok


def phase_train_parity():
    """One f32 step of the full-width LM at batch 2: the card (kernels)
    against a CPU copy (plain attention)."""
    on_card, on_cpu, step = parity_setup()
    _zero_counts()
    t0 = time.perf_counter()
    card = step(on_card, "cuda")
    t1 = time.perf_counter()
    used = _read_counts()
    routes = _read_routes()
    cpu = step(on_cpu, "cpu")
    t2 = time.perf_counter()
    if [used[f"flash_attention_{n}"] for n in ("fwd", "dq", "dkv")] != \
            [LAYERS] * 3:
        raise RuntimeError(f"the card step launched {used}, not "
                           f"{LAYERS} forward, dQ and dK/dV each")
    # f32 keeps the scalar forward, dQ and dK/dV
    for name in DENSE_NAMES[:3]:
        _check_routes(routes, name, {"tensor_core": 0, "scalar": LAYERS},
                      "f32 LM step")
    print(f"train parity: card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    norm, worst, ok = parity_report(card, cpu)
    if not ok:
        raise RuntimeError("loss or gradients differ beyond the stated "
                           "bounds")
    return norm, worst


# ---------------------------------------------------------------------------
# 7b-7c. sequence-parallel training, and its step held against the dense one
# ---------------------------------------------------------------------------

# visible chunk pairs of a causal ring over SP_SHARDS shards: n (n + 1) / 2
SP_PAIRS = SP_SHARDS * (SP_SHARDS + 1) // 2
RING_NAMES = ("flash_attention_partial", "flash_attention_dq_partial",
              "flash_attention_dkv_partial")
DENSE_NAMES = ("flash_attention_fwd", "flash_attention_dq",
               "flash_attention_dkv", "flash_attention_dbias")


# a short profiled run after a timed training run: device time per step,
# beside the unprofiled run's step time, gives the device's idle share
BUSY_ITERS, BUSY_EPOCHS = 2, 2


def dispatch_of(k, then=None):
    """``configure`` for ``perf.run``: windows of ``k`` steps (k > 1: CUDA
    graph replays), then ``then(optimizer)`` where given."""
    def configure(opt):
        opt.set_iterations_per_dispatch(k)
        if then is not None:
            then(opt)
    return configure


def device_events(prof):
    """The device's events of a ``torch.profiler`` run, in the order they
    started, but the dataset's upload (Memcpy HtoD)."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "HtoD" not in e.name),
                  key=lambda e: e.time_range.start)


def device_steps(opt, steps):
    """The steps the device ran in a run of ``steps`` steps: a dispatched
    run also runs one warm-up step per captured graph."""
    return steps + getattr(opt, "dispatch_stats", {}).get("captures", 0)


def profile_steps(args, model, criterion, make_batch, configure=None):
    """A short run (BUSY_ITERS x BUSY_EPOCHS steps) of the same training
    on the warmed model under ``torch.profiler`` (``configure`` as
    ``perf.run`` takes it): returns the device's busy ms per step, every
    kernel, set and copy on the device but the dataset's upload, summed
    over the steps the device ran.  Launches it makes are counted by the
    wrappers, so it runs after a phase has read its counts."""
    import argparse
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.examples import perf
    short = argparse.Namespace(**{**vars(args), "iterations": BUSY_ITERS,
                                  "epochs": BUSY_EPOCHS})
    # left out when None: an older checkout's perf.run does not take it
    kw = {} if configure is None else {"configure": configure}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, opt = perf.run(short, model, criterion, make_batch, **kw)
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    return busy_us / device_steps(opt, BUSY_ITERS * BUSY_EPOCHS) / 1e3



def _busy_text(label, busy_ms, step_ms):
    return (f"{label}: device busy {busy_ms:.3f} ms per step (torch."
            f"profiler over {BUSY_ITERS * BUSY_EPOCHS} steps) of the "
            f"{step_ms} ms step: idle share {1 - busy_ms / step_ms:.3f}")


def seq_mesh():
    """The SP phases' mesh: SP_SHARDS shards of the sequence, all on the
    one card."""
    from bigdl_tpu_torch.parallel import make_mesh
    return make_mesh({"seq": SP_SHARDS}, devices=["cuda"] * SP_SHARDS)


def phase_sp_training():
    """The LM training run of phase 6 with every block's self-attention
    through ring attention over seq_mesh(); each call of #5-#7 bracketed
    by CUDA events, so the last epoch's steps split into the three kernels
    and the rest."""
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.ops import attention_kernels as ak
    args = perf.parse_args(TRAIN_ARGV)
    model, criterion, make_batch = perf.build(args.model, args)
    model.lm.set_sequence_parallel(seq_mesh(), "seq")
    kernels = ak._RING_KERNELS
    logs = {fn.__name__: [] for fn in kernels}
    ak._RING_KERNELS = tuple(_timed(fn, logs[fn.__name__]) for fn in kernels)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        out, opt = perf.run(args, model, criterion, make_batch)
    finally:
        ak._RING_KERNELS = kernels
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    routes = _read_routes()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = TRAIN_ITERS * TRAIN_EPOCHS
    per_step = LAYERS * SP_PAIRS
    losses = [loss for _, loss in opt.loss_history]
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (out["ms_per_iteration"] / 1e3)
    kernel_ms = {name: sum(s.elapsed_time(e) for s, e in
                           log[-per_step * TRAIN_ITERS:]) / TRAIN_ITERS
                 for name, log in logs.items()}
    rest_ms = out["ms_per_iteration"] - sum(kernel_ms.values())
    print(f"sp training: {json.dumps(out)}")
    print(f"sp training: {SP_SHARDS} shards of T{TRAIN_SEQ // SP_SHARDS} on "
          f"one card; {steps} steps in {wall:.3f} s; "
          f"{out['records_per_sec']} records/s, {tokens_s:.1f} tokens/s, "
          f"{out['ms_per_iteration']} ms/iteration (steady windows); "
          f"first window {out['compile_plus_first_window_s']} s; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; peak memory "
          f"{peak_gb:.3f} GiB; launches {launches}; routes {routes}")
    print("sp training: last epoch, device ms per step: "
          + ", ".join(f"{n} {t:.3f} ({per_step} launches)"
                      for n, t in kernel_ms.items())
          + f"; the rest {rest_ms:.3f}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite or missing: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    want = {n: (per_step * steps if n in RING_NAMES else 0)
            for n in launches}
    if launches != want:
        raise RuntimeError(f"launches {launches} != {want} ({LAYERS} layers "
                           f"x {SP_PAIRS} chunk pairs x {steps} steps)")
    # every bf16 launch of #5, #6 and #7 took the tensor cores
    for name in RING_NAMES:
        _check_routes(routes, name, {"tensor_core": want[name], "scalar": 0},
                      "bf16 SP LM training")
    busy = profile_steps(args, model, criterion, make_batch)
    print(_busy_text("sp training", busy, out["ms_per_iteration"]))
    return dict(out, tokens_per_sec=tokens_s, steps=steps,
                first_loss=losses[0], last_loss=losses[-1],
                peak_memory_gib=peak_gb, launches=launches, routes=routes,
                kernel_ms_per_step=kernel_ms, rest_ms_per_step=rest_ms,
                device_busy_ms_per_step=busy)


def phase_sp_parity():
    """One f32 step of the full-width LM at batch 2 through ring attention
    (#5-#7) against the same step through dense attention (#1-#3), from
    the same weights and tokens, within phase 7's bounds."""
    import copy
    dense, _, step = parity_setup()
    ring = copy.deepcopy(dense)
    ring.lm.set_sequence_parallel(seq_mesh(), "seq")
    _zero_counts()
    ring_step = step(ring, "cuda")
    used_ring = _read_counts()
    for name in RING_NAMES:
        _check_routes(_read_routes(), name,
                      {"tensor_core": 0, "scalar": LAYERS * SP_PAIRS},
                      "f32 ring step")
    _zero_counts()
    dense_step = step(dense, "cuda")
    used_dense = _read_counts()
    for name in DENSE_NAMES[:3]:
        _check_routes(_read_routes(), name,
                      {"tensor_core": 0, "scalar": LAYERS}, "f32 dense step")
    want_ring = {n: (LAYERS * SP_PAIRS if n in RING_NAMES else 0)
                 for n in used_ring}
    want_dense = {n: (LAYERS if n in DENSE_NAMES[:3] else 0)
                  for n in used_dense}
    if used_ring != want_ring or used_dense != want_dense:
        raise RuntimeError(f"the ring step launched {used_ring}, the dense "
                           f"step {used_dense}")
    norm, worst, ok = parity_report(
        ring_step, dense_step, "sp parity",
        what=f"batch {PARITY_BATCH}, T{TRAIN_SEQ}, {SP_SHARDS} shards",
        sides=("ring", "dense"))
    if not ok:
        raise RuntimeError("the ring step's loss or gradients differ from "
                           "the dense step's beyond the stated bounds")
    return norm, worst


# ---------------------------------------------------------------------------
# 8. the conv+BN kernels #8-#11 against their plain versions
# ---------------------------------------------------------------------------

RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
CONV_RUNS = 10                     # timed runs per call (median)
# f32: the kernels sum their products in another order than cuBLAS and
# cuDNN, so each output is held to 1e-4 of the plain output's largest
# entry.  bf16 (y, dx, dW): each entry within one bf16 ulp of the plain
# version's, and at most 1% of the entries differing at all: another f32
# summation order moves only entries next to a rounding boundary, where a
# missing cast moves a large share (chip_gate_controls.py).  An entry
# that a long sum cancels to near zero has an ulp below both f32 sums'
# own rounding, so an entry may also differ by up to 1e-5 of the
# output's largest.  Statistics: within 1e-5 of sum |y - K| (s1) and of
# sum (y - K)^2 (s2), summed in f64 from the kernel's own y
CONV_F32_REL, CONV_BF16_SHARE, CONV_BF16_FLOOR, CONV_STATS_REL = \
    1e-4, 0.01, 1e-5, 1e-5
CONV_OUTPUTS = ("y", "dx", "dw", "dsx", "dsu")


def _conv_ops(kind):
    """(forward, backward, their plain versions) of a 1x1 or a 3x3."""
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    if kind == "1x1":
        return (ck.matmul_bn_fwd, ck.matmul_bn_bwd, ck.plain_matmul_bn_fwd,
                ck.plain_matmul_bn_bwd)
    return (ck.conv3x3_bn_fwd, ck.conv3x3_bn_bwd, ck.plain_conv3x3_bn_fwd,
            ck.plain_conv3x3_bn_bwd)


def conv_problems():
    """(key, kind, shape, dtype, norm given): ResNet-50's own shapes at
    b128, then ragged small ones (M = 63 or 100 rows, not a multiple of
    the 64-row tile; 72 output channels, not a multiple of 64; H = 3,
    W = 7) in f32 and bf16, with the norm given and absent.  A 1x1's
    shape is (M, K, N), a 3x3's (B, H, W, C, Co)."""
    b, bf, f32 = RESNET_BATCH, torch.bfloat16, torch.float32
    rows = [
        ("s1_conv1", "1x1", (b * 56 * 56, 64, 64), bf, False),
        ("s1_conv3", "1x1", (b * 56 * 56, 64, 256), bf, True),
        ("s3_conv1", "1x1", (b * 14 * 14, 1024, 256), bf, False),
        ("s4_conv3", "1x1", (b * 7 * 7, 512, 2048), bf, True),
        ("s1_conv2", "3x3", (b, 56, 56, 64, 64), bf, True),
        ("s2_conv2", "3x3", (b, 28, 28, 128, 128), bf, True),
        ("s3_conv2", "3x3", (b, 14, 14, 256, 256), bf, True),
        ("s4_conv2", "3x3", (b, 7, 7, 512, 512), bf, True),
    ]
    for dtype, tag in ((f32, "f32"), (bf, "bf16")):
        for norm in (True, False):
            n = "norm" if norm else "nonorm"
            rows.append((f"r1_{tag}_{n}", "1x1", (100, 24, 72), dtype, norm))
            rows.append((f"r3_{tag}_{n}", "3x3", (3, 3, 7, 20, 72), dtype,
                         norm))
    return rows


def conv_what(kind, shape, dtype, norm):
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    n = "norm" if norm else "no norm"
    if kind == "1x1":
        return f"M{shape[0]} K{shape[1]} N{shape[2]} {dt} {n}"
    b, h, w, c, co = shape
    return f"B{b} {h}x{w} C{c} Co{co} {dt} {n}"


def conv_inputs(kind, shape, dtype, gen):
    """x, w, the f32 vectors (mean, scale, beta, kshift), dy and the
    statistics cotangents gm, gs (nonzero) on the card."""
    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device="cuda") * scale
    if kind == "1x1":
        m, c, co = shape
        x_shape, w_shape, y_shape, fan = (m, c), (c, co), (m, co), c
    else:
        b, h, wd, c, co = shape
        x_shape, w_shape, y_shape = (b, h, wd, c), (3, 3, c, co), (b, h, wd,
                                                                  co)
        fan = 9 * c
    x = (rnd(*x_shape, scale=1.5) + 0.3).to(dtype)
    w = rnd(*w_shape, scale=(2.0 / fan) ** 0.5).to(dtype)
    vec = (rnd(c, scale=0.1), rnd(c).abs() + 0.5, rnd(c, scale=0.2),
           rnd(co, scale=0.05))
    return x, w, vec, rnd(*y_shape).to(dtype), rnd(co, scale=0.1), \
        rnd(co, scale=0.1)


def conv_held(got, want):
    """(max abs err, entries that differ, within the rule of the dtype)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    differ = int((got != want).sum())
    if want.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        tol = ulp.clamp_min(CONV_BF16_FLOOR * float(w.abs().max()))
        ok = bool((diff <= tol).all()) and \
            differ <= CONV_BF16_SHARE * want.numel()
    else:
        ok = err <= CONV_F32_REL * float(w.abs().max())
    return err, differ, ok


def conv_stats_held(s1, s2, y, kshift):
    """(worst error relative to its bound's scale, within the bounds):
    s1 against sum(y-K) and s2 against sum((y-K)^2), in f64 from y."""
    yk = y.double().reshape(-1, y.shape[-1]) - kshift.double()
    own1, mass, own2 = yk.sum(0), yk.abs().sum(0), (yk * yk).sum(0)
    rel1 = (s1.double() - own1).abs() / mass.clamp_min(1e-30)
    rel2 = (s2.double() - own2).abs() / own2.clamp_min(1e-30)
    worst = float(torch.maximum(rel1.max(), rel2.max()))
    return worst, worst <= CONV_STATS_REL


def check_conv(kind, x, w, vec, dy, gm, gs, fuse):
    """Kernels #8/#9 (1x1) or #10/#11 (3x3), with statistics, against their
    plain versions on the same inputs (both backwards fold with the forward
    kernel's y, as the Functions save it); each launched twice.  Returns
    ({output: (max abs err, entries that differ, held)}, (stats error,
    held), same bits)."""
    fwd, bwd, plain_fwd, plain_bwd = _conv_ops(kind)
    flags = dict(fuse_input=fuse, emit_stats=True)
    with torch.no_grad():
        got = fwd(x, w, *vec, **flags)
        again = fwd(x, w, *vec, **flags)
        want = plain_fwd(x, w, *vec, **flags)
        grads = bwd(x, w, *vec, got[0], dy, gm, gs, **flags)
        grads_again = bwd(x, w, *vec, got[0], dy, gm, gs, **flags)
        grads_want = plain_bwd(x, w, *vec, got[0], dy, gm, gs, **flags)
    torch.cuda.synchronize()
    outs = (*got, *grads)
    if not all(torch.isfinite(t).all() for t in outs):
        raise RuntimeError(f"{kind}: a kernel output is not finite")
    repeatable = all(torch.equal(a, b) for a, b in
                     zip(outs, (*again, *grads_again)))
    held = {name: conv_held(g, p) for name, g, p in
            zip(CONV_OUTPUTS, (got[0], *grads), (want[0], *grads_want))}
    return held, conv_stats_held(got[1], got[2], got[0], vec[3]), repeatable


def conv_bound(kind, direction, shape, dtype, rates):
    """Least device time of one call: each input read once and each output
    written once (the backward's dW counted as f32; it reads the saved y)
    over the memory rate, or its operations over the peak rate of its
    type: 2 per multiply-add of the product, forward; 4 backward."""
    mem_rate, f32_rate, bf16_rate = rates
    size = 2 if dtype == torch.bfloat16 else 4
    if kind == "1x1":
        (m, c, co), taps = shape, 1
    else:
        b, h, wd, c, co = shape
        m, taps = b * h * wd, 9
    x_b, w_b, y_b = m * c * size, taps * c * co * size, m * co * size
    macs = m * c * co * taps
    if direction == "fwd":
        nbytes, ops = x_b + w_b + y_b, 2 * macs
    else:
        # x, y, dy, W in; dx and the f32 dW out
        nbytes = 2 * x_b + 2 * y_b + w_b + taps * c * co * 4
        ops = 4 * macs
    peak = bf16_rate if dtype == torch.bfloat16 else f32_rate
    t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def conv_library(kind, direction, x, w, dy):
    """One PyTorch call for the product alone (a yardstick the port never
    calls): cuBLAS's z.W (forward) or z^T.dy and dy.W^T (backward) for
    the 1x1; cuDNN's conv2d or its convolution_backward (input and weight
    gradients) for the 3x3."""
    import torch.nn.functional as F
    if kind == "1x1":
        if direction == "fwd":
            return lambda: torch.matmul(x, w)
        return lambda: (torch.matmul(x.t(), dy), torch.matmul(dy, w.t()))
    xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if direction == "fwd":
        return lambda: F.conv2d(xn, wn, padding=1)
    return lambda: torch.ops.aten.convolution_backward(
        dyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, False])


def phase_conv_kernel_checks(rates):
    """#8-#11 against their plain versions at every shape of
    conv_problems(); times beside the plain versions, the library's
    product and the bound."""
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    for key, kind, shape, dtype, norm in conv_problems():
        t0 = time.perf_counter()
        what = conv_what(kind, shape, dtype, norm)
        x, w, vec, dy, gm, gs = conv_inputs(kind, shape, dtype, gen)
        held, (stats_err, stats_ok), repeatable = check_conv(
            kind, x, w, vec, dy, gm, gs, norm)
        bad = [n for n, (_, _, ok) in held.items() if not ok]
        if not repeatable or bad or not stats_ok:
            raise RuntimeError(
                f"conv {key} ({what}): same bits {repeatable}; outputs "
                f"beyond their rule {bad}; statistics error {stats_err:.3e} "
                f"(bound {CONV_STATS_REL}); readings {held}")
        fwd, bwd, plain_fwd, plain_bwd = _conv_ops(kind)
        flags = dict(fuse_input=norm, emit_stats=True)
        with torch.no_grad():
            y = fwd(x, w, *vec, **flags)[0]
            bwd_args = (x, w, *vec, y, dy, gm, gs)
            calls = {
                "fwd": (fwd, plain_fwd, (x, w, *vec)),
                "bwd": (bwd, plain_bwd, bwd_args),
            }
            for direction, (kernel, plain, args) in calls.items():
                outs = ("y",) if direction == "fwd" else CONV_OUTPUTS[1:]
                row = {
                    "kernel": kernel.__name__, "shape": key, "what": what,
                    "route": {"matmul_bn_fwd": ck.matmul_fwd_route,
                              "matmul_bn_bwd": ck.matmul_bwd_route,
                              "conv3x3_bn_fwd": ck.conv3x3_fwd_route,
                              "conv3x3_bn_bwd": ck.conv3x3_bwd_route}[
                                  kernel.__name__](dtype),
                    "max_abs_err": max(held[o][0] for o in outs),
                    "entries_differ": {o: held[o][1] for o in outs},
                    "stats_rel_err": stats_err if direction == "fwd"
                    else None,
                    "bitwise_repeatable": True,
                    "ms": time_ms(lambda: kernel(*args, **flags), flush,
                                  runs=CONV_RUNS, warmup=2),
                    "plain_ms": time_ms(lambda: plain(*args, **flags),
                                        flush, runs=CONV_RUNS, warmup=2),
                    "library_ms": time_ms(
                        conv_library(kind, direction, x, w, dy), flush,
                        runs=CONV_RUNS, warmup=2),
                }
                row["bound_ms"], row["bound_by"] = conv_bound(
                    kind, direction, shape, dtype, rates)
                if row["route"] == "tensor_core":
                    row["device_split_ms"] = device_split(
                        lambda: kernel(*args, **flags))
                results.append(row)
                print(f"conv {row['kernel']:14s} {key:16s} {what:36s} "
                      f"max_abs_err {row['max_abs_err']:.3e} differ "
                      f"{row['entries_differ']} repeatable  kernel_ms "
                      f"{row['ms']:.5f}  plain_ms {row['plain_ms']:.5f}  "
                      f"library_ms {row['library_ms']:.5f}  bound_ms "
                      f"{row['bound_ms']:.5f} ({row['bound_by']})"
                      + _split_text(row))
        print(f"  ({key}: statistics within {stats_err:.3e} of their own "
              f"sums; {time.perf_counter() - t0:.1f} s)")
        del x, w, vec, dy, y, bwd_args, calls
    return results


# ---------------------------------------------------------------------------
# 9-11. ResNet-50 training, fused against plain, and a step against the CPU
# ---------------------------------------------------------------------------

RESNET_ITERS, RESNET_EPOCHS = 4, 3
RESNET_ARGV = ["--model", "resnet50", "--fused", "--bf16",
               "-b", str(RESNET_BATCH), "--image-size", str(RESNET_SIZE),
               "--classes", str(RESNET_CLASSES),
               "--iterations", str(RESNET_ITERS),
               "--epochs", str(RESNET_EPOCHS)]
# launches of #8, #9, #10, #11 in one step: conv1 and conv3 of the 16
# bottlenecks, conv2 of the 13 whose 3x3 has stride 1
RESNET_LAUNCHES = {"matmul_bn_fwd": 32, "matmul_bn_bwd": 32,
                   "conv3x3_bn_fwd": 13, "conv3x3_bn_bwd": 13}
# the conv kernels with a tensor-core route for bf16 (#8-#11)
TC_CONV = ("matmul_bn_fwd", "matmul_bn_bwd", "conv3x3_bn_fwd",
           "conv3x3_bn_bwd")
# fused against plain, one bf16 step (bench.py's own cross-check of the
# fused step: 5% of the loss); each running statistic within 1e-2 of its
# tensor's largest entry: the two paths round at the same points, so only
# the products' summation order differs
FUSED_LOSS_REL, FUSED_STAT_REL = 5e-2, 1e-2


def _timed(fn, log):
    """``fn`` between two CUDA events recorded on the current stream; the
    pair goes into ``log``."""
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((start, end))
        return out
    return run


def phase_resnet_training():
    """ResNet-50 at the reference's benchmark shape through the port's perf
    training path, bf16 compute, the fused bottleneck on.  Each kernel
    call is bracketed by CUDA events, so the last epoch's steps split into
    the four kernels and the rest."""
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.ops import conv_bn_kernels as ck
    logs = {fn.__name__: [] for fn in ck._KERNELS}
    args = perf.parse_args(RESNET_ARGV)
    model, criterion, make_batch = perf.build(args.model, args)
    kernels = ck._KERNELS
    ck._KERNELS = tuple(_timed(fn, logs[fn.__name__]) for fn in kernels)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        out, opt = perf.run(args, model, criterion, make_batch)
    finally:
        ck._KERNELS = kernels
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    routes = _read_routes()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = RESNET_ITERS * RESNET_EPOCHS
    losses = [loss for _, loss in opt.loss_history]
    kernel_ms = {name: sum(s.elapsed_time(e) for s, e in
                           log[-RESNET_LAUNCHES[name] * RESNET_ITERS:])
                 / RESNET_ITERS for name, log in logs.items()}
    rest_ms = out["ms_per_iteration"] - sum(kernel_ms.values())
    print(f"resnet training: {json.dumps(out)}")
    print(f"resnet training: {steps} steps in {wall:.3f} s; "
          f"{out['records_per_sec']} images/s, {out['ms_per_iteration']} "
          f"ms/iteration (steady windows); first window "
          f"{out['compile_plus_first_window_s']} s; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; peak memory {peak_gb:.3f} GiB; launches "
          f"{launches}")
    print(f"resnet training: peak memory allocated "
          f"{torch.cuda.max_memory_allocated()} bytes "
          f"(torch.cuda.max_memory_allocated over the run)")
    print("resnet training: last epoch, device ms per step: "
          + ", ".join(f"{n} {t:.3f} ({RESNET_LAUNCHES[n]} launches)"
                      for n, t in kernel_ms.items())
          + f"; the rest {rest_ms:.3f}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite or missing: {losses}")
    first, last = losses[:RESNET_ITERS], losses[-RESNET_ITERS:]
    if not np.mean(last) < np.mean(first):
        raise RuntimeError(f"the last window's loss did not fall below the "
                           f"first's: {losses}")
    want = {n: RESNET_LAUNCHES.get(n, 0) * steps for n in launches}
    if launches != want:
        raise RuntimeError(f"launches {launches} != {want} ({steps} steps)")
    print(f"resnet training: routes {routes}")
    # every bf16 launch of #8-#11 took the tensor cores
    for name in TC_CONV:
        _check_routes(routes, name, {"tensor_core": want[name], "scalar": 0},
                      "bf16 ResNet-50 training")
    busy = profile_steps(args, model, criterion, make_batch)
    print(_busy_text("resnet training", busy, out["ms_per_iteration"]))
    return dict(out, steps=steps, first_loss=losses[0],
                last_loss=losses[-1], peak_memory_gib=peak_gb,
                launches=launches, routes=routes, kernel_ms_per_step=kernel_ms,
                rest_ms_per_step=rest_ms, device_busy_ms_per_step=busy)


def _one_step(model, x, y, dtype=None):
    """One SGD step of ``model`` on the batch (x, y) through the port's
    Optimizer; returns its loss."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    opt = (Optimizer(model, DataSet.array([MiniBatch(x, y)], shuffle=False),
                     CrossEntropyCriterion())
           .set_optim_method(SGD(0.01, momentum=0.9, dampening=0.0))
           .set_end_when(Trigger.max_iteration(1))
           .set_compute_dtype(dtype))
    opt.optimize()
    return opt.loss_history[0][1]


def phase_fused_vs_plain():
    """One bf16 step with the fused path and one with it switched off by
    the environment, at full width from the same weights and batch."""
    import copy
    import os
    from bigdl_tpu_torch.models import resnet
    fused = resnet.resnet50(RESNET_CLASSES, fused=True,
                            generator=torch.Generator().manual_seed(2),
                            device="cuda")
    plain = copy.deepcopy(fused)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3)) \
        .astype(np.float32)
    y = rng.integers(1, RESNET_CLASSES + 1, size=(RESNET_BATCH,))
    _zero_counts()
    loss_fused = _one_step(fused, x, y, torch.bfloat16)
    used = _read_counts()
    for name in TC_CONV:
        _check_routes(_read_routes(), name,
                      {"tensor_core": RESNET_LAUNCHES[name], "scalar": 0},
                      "fused bf16 step")
    os.environ[resnet.FUSED_ENV] = "0"
    try:
        loss_plain = _one_step(plain, x, y, torch.bfloat16)
    finally:
        del os.environ[resnet.FUSED_ENV]
    if used != _read_counts() or used != {
            n: RESNET_LAUNCHES.get(n, 0) for n in used}:
        raise RuntimeError(f"the fused step launched {used}, the plain "
                           f"step {_read_counts()}")
    stats = {}
    for (name, a), b in zip(fused.named_buffers(), plain.buffers()):
        scale = max(float(b.abs().max()), 1e-30)
        stats[name] = float((a - b).abs().max()) / scale
    worst = max(stats, key=stats.get)
    loss_rel = abs(loss_fused - loss_plain) / abs(loss_plain)
    print(f"fused vs plain: bf16 step at b{RESNET_BATCH} {RESNET_SIZE} px: "
          f"loss fused {loss_fused:.6f} plain {loss_plain:.6f} (relative "
          f"{loss_rel:.3e}); over {len(stats)} running statistics the worst "
          f"is {stats[worst]:.3e} of its largest entry ({worst})")
    if loss_rel > FUSED_LOSS_REL or stats[worst] > FUSED_STAT_REL:
        raise RuntimeError("the fused and plain steps disagree beyond "
                           f"{FUSED_LOSS_REL} (loss) or {FUSED_STAT_REL} "
                           "(running statistics)")
    return dict(loss_fused=loss_fused, loss_plain=loss_plain,
                loss_rel=loss_rel, worst_stat_rel=stats[worst])


# f32 fused step of ResNet-50 at batch 4, 64 px, card against CPU: the
# loss is a mean over 4 images (1e-5 relative).  Each gradient is held to
# 1e-2 in norm (||card - cpu|| / ||cpu||) and to 5e-2 of its largest
# entry.  Sums in another order can flip a ReLU whose input lies within
# rounding of zero, and one flip moves the small, cancelling gradients
# of a BatchNorm by a share of its positions; chip_gate_controls.py
# reads how far two CPU steps whose inputs differ by 2^-23 drift apart,
# and shows the same step with the conv kernels fed bf16-rounded x and
# W refused (PERF.md)
RESNET_PARITY_BATCH, RESNET_PARITY_SIZE = 4, 64
RESNET_PARITY_BOUNDS = (1e-5, 1e-2, 5e-2)


def resnet_parity_setup():
    """ResNet-50 on the card in train mode with the fused path, its CPU
    copy, and :func:`grad_step` over one fixed batch.  The BatchNorm
    weights are drawn from U(0.5, 1), those of each block's last BN from
    U(0.03, 0.06): the zero-initialised last BN would give every conv
    kernel's backward a zero cotangent, and a residual branch scaled
    small keeps the 16-block step well conditioned."""
    import copy
    from bigdl_tpu_torch.models import resnet50
    on_card = resnet50(RESNET_CLASSES, fused=True,
                       generator=torch.Generator().manual_seed(1),
                       device="cuda")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in on_card.named_parameters():
            if "bn" in name and name.endswith("weight"):
                low = 0.03 if name.endswith("bn3.weight") else 0.5
                p.copy_(torch.rand(p.shape, generator=gen) * low + low)
    on_cpu = copy.deepcopy(on_card).to("cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(RESNET_PARITY_BATCH, RESNET_PARITY_SIZE,
                         RESNET_PARITY_SIZE, 3)).astype(np.float32)
    y = rng.integers(1, RESNET_CLASSES + 1, (RESNET_PARITY_BATCH,))
    return on_card, on_cpu, grad_step(x, y)


def resnet_parity_report(card, cpu, label="resnet parity"):
    return parity_report(
        card, cpu, label, RESNET_PARITY_BOUNDS,
        f"batch {RESNET_PARITY_BATCH}, {RESNET_PARITY_SIZE} px, ResNet-50 "
        "fused")


def phase_resnet_parity():
    """One f32 fused step of ResNet-50: the card (kernels #8-#11, cuDNN
    in full f32 for the unfused convs) against a CPU copy (the kernels'
    plain versions)."""
    on_card, on_cpu, step = resnet_parity_setup()
    _zero_counts()
    t0 = time.perf_counter()
    card = step(on_card, "cuda")
    t1 = time.perf_counter()
    used = _read_counts()
    routes = _read_routes()
    cpu = step(on_cpu, "cpu")
    t2 = time.perf_counter()
    if used != {n: RESNET_LAUNCHES.get(n, 0) for n in used}:
        raise RuntimeError(f"the card step launched {used}")
    # f32 keeps the scalar #8-#11
    for name in TC_CONV:
        _check_routes(routes, name,
                      {"tensor_core": 0, "scalar": RESNET_LAUNCHES[name]},
                      "f32 ResNet-50 step")
    print(f"resnet parity: card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    norm, worst, ok = resnet_parity_report(card, cpu)
    if not ok:
        raise RuntimeError("loss or gradients differ beyond the stated "
                           "bounds")
    return norm, worst


# ---------------------------------------------------------------------------
# 12-13. LeNet-5 through the Optimizer façade, and the dispatch windows
# ---------------------------------------------------------------------------

# the reference perf's own LeNet invocation (examples/perf.py:7), 4 epochs
LENET_ARGV = ["--model", "lenet", "-b", "256", "--iterations", "50"]
LENET_VAL_BATCHES, LENET_L2, LENET_CLIP = 4, 5e-4, 1.0
# a 20-step f32 trajectory, card (graph windows of LENET_TRAJ_ITERS)
# against a CPU copy: each loss 1e-5 relative, each parameter 1e-4
# relative in norm (the existing parity phases' rules)
LENET_TRAJ_ITERS, LENET_TRAJ_EPOCHS = 5, 4
LENET_LOSS_RTOL, LENET_PARAM_NORM_REL = 1e-5, 1e-4


def lenet_configure(val_batches, validate=True):
    """``configure`` for ``perf.run``: every-epoch validation (Top1,
    Top5, Loss) on ``val_batches`` and clipping by the L2 norm."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy, \
        Top5Accuracy

    def configure(opt):
        device = next(opt.model.parameters()).device
        if validate:
            val = DataSet.array([MiniBatch(x, y) for x, y in val_batches],
                                shuffle=False).cache_on_device(device)
            opt.set_validation(Trigger.every_epoch(), val,
                               [Top1Accuracy(), Top5Accuracy(),
                                Loss(ClassNLLCriterion())])
        opt.set_gradient_clipping_by_l2_norm(LENET_CLIP)
    return configure


def lenet_model(args):
    """LeNet5(10) as perf.build makes it, with an L2 regularizer on fc1,
    its criterion, its batch maker and the validation batches."""
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.optim.regularizer import L2Regularizer
    model, criterion, make_batch = perf.build("lenet", args)
    fc1 = next(m for m in model.modules() if getattr(m, "name", "") == "fc1")
    fc1.set_regularizers(w_regularizer=L2Regularizer(LENET_L2))
    # the training batch first, as perf.run would draw it
    x, y = make_batch(args.batch_size)
    val = [make_batch(args.batch_size) for _ in range(LENET_VAL_BATCHES)]
    return model, criterion, (lambda b: (x, y)), val


@contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside (cuDNN's and the
    embedding backward's deterministic kernels: a graph run is held bit
    for bit against an eager one), warning where an operation has no
    deterministic kernel; yields the set of such operations."""
    import warnings
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    nondet = set()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield nondet
            nondet.update(str(w.message).split(".")[0] for w in caught
                          if "deterministic" in str(w.message))
    finally:
        torch.use_deterministic_algorithms(was)


def _lenet_run(args, k):
    """One timed LeNet run with windows of ``k`` (1: eager), and the
    device's busy time over a short run of the same configuration (no
    validation)."""
    from bigdl_tpu_torch.examples import perf
    steps = args.iterations * args.epochs
    model, criterion, make_batch, val = lenet_model(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, opt = perf.run(args, model, criterion, make_batch,
                        configure=dispatch_of(k, lenet_configure(val)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model2, criterion2, make_batch2, val2 = lenet_model(args)
    busy = profile_steps(args, model2, criterion2, make_batch2,
                         configure=dispatch_of(min(k, BUSY_ITERS),
                                               lenet_configure(val2, False)))
    losses = [x for _, x in opt.loss_history]
    print(f"lenet: k={k}: {json.dumps(out)}")
    print(f"lenet: k={k}: {steps} steps in {wall:.3f} s; "
          f"{out['records_per_sec']} images/s, "
          f"{out['ms_per_iteration']} ms/iteration (steady windows); "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; validations "
          + "; ".join(f"at {n}: " + ", ".join(
              f"{name} {r.result()[0]:.4f} of {r.result()[1]}"
              for name, r in res.items())
              for n, res in opt.validation_history)
          + f"; dispatch {opt.dispatch_stats}; peak memory {peak} bytes")
    print(_busy_text(f"lenet: k={k}", busy, out["ms_per_iteration"]))
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite or missing: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the LeNet loss did not fall: {losses}")
    return dict(out=out, opt=opt, model=model, wall=wall, peak=peak,
                busy=busy)


def phase_lenet():
    """LeNet-5 at the reference perf's width (b256, 28x28x1, f32) through
    the Optimizer with validation, an L2 regularizer on fc1 and clipping
    by the L2 norm: eagerly, then with windows of an epoch's iterations
    (CUDA graph replays), deterministic algorithms on for both, which
    must match bit for bit; then a 20-step f32 trajectory on the card
    (graph windows) against a CPU copy."""
    import argparse
    import copy
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(LENET_ARGV)
    steps = args.iterations * args.epochs
    _zero_counts()
    with deterministic() as nondet:
        runs = {k: _lenet_run(args, k) for k in (1, args.iterations)}
    print(f"lenet: operations without a deterministic implementation: "
          f"{sorted(nondet) or 'none'}; launches of #1-#11 "
          f"{_read_counts()}")
    if any(_read_counts().values()):
        raise RuntimeError("the LeNet path launched a kernel of #1-#11")
    eager, graph = runs[1], runs[args.iterations]
    if graph["opt"].dispatch_stats != {
            "single_steps": 0, "window_steps": steps, "captures": 1,
            "replays": steps}:
        raise RuntimeError(f"the windowed LeNet run dispatched "
                           f"{graph['opt'].dispatch_stats}")
    same_losses = eager["opt"].loss_history == graph["opt"].loss_history
    same_params = all(torch.equal(p, q) for p, q in zip(
        eager["model"].parameters(), graph["model"].parameters()))
    same_val = [(n, {m: r.result() for m, r in res.items()})
                for n, res in eager["opt"].validation_history] == \
        [(n, {m: r.result() for m, r in res.items()})
         for n, res in graph["opt"].validation_history]
    print(f"lenet: graph windows against eager: losses "
          f"{'equal' if same_losses else 'DIFFER'}, parameters "
          f"{'equal' if same_params else 'DIFFER'}, validations "
          f"{'equal' if same_val else 'DIFFER'} bit for bit")
    if not (same_losses and same_params and same_val):
        raise RuntimeError("the LeNet graph run is not the eager run")

    # 20 f32 steps on the card in graph windows against a CPU copy
    short = argparse.Namespace(**{**vars(args),
                                  "iterations": LENET_TRAJ_ITERS,
                                  "epochs": LENET_TRAJ_EPOCHS})
    card, criterion, make_batch, val = lenet_model(short)
    cpu = copy.deepcopy(card).to("cpu")
    _, opt_card = perf.run(short, card, criterion, make_batch,
                           configure=dispatch_of(LENET_TRAJ_ITERS,
                                                 lenet_configure(val)))
    short.device = "cpu"
    _, opt_cpu = perf.run(short, cpu, criterion, make_batch,
                          configure=lenet_configure(val))
    a = np.array([v for _, v in opt_card.loss_history])
    b = np.array([v for _, v in opt_cpu.loss_history])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    norm_rel = {n: float((p.detach().cpu() - q.detach()).norm()
                         / q.detach().norm())
                for (n, p), q in zip(card.named_parameters(),
                                     cpu.parameters())}
    worst = max(norm_rel, key=norm_rel.get)
    tops = [(n, round(r["Top1Accuracy"].result()[0] * r["Top1Accuracy"]
                      .result()[1])) for n, r in opt_card.validation_history]
    tops_cpu = [(n, round(r["Top1Accuracy"].result()[0]
                          * r["Top1Accuracy"].result()[1]))
                for n, r in opt_cpu.validation_history]
    ok = (len(a) == len(b) == LENET_TRAJ_ITERS * LENET_TRAJ_EPOCHS
          and loss_rel <= LENET_LOSS_RTOL
          and norm_rel[worst] <= LENET_PARAM_NORM_REL)
    print(f"lenet parity: {len(a)} f32 steps, card (graph windows of "
          f"{LENET_TRAJ_ITERS}) against the CPU: worst loss "
          f"{loss_rel:.3e} relative, worst parameter {norm_rel[worst]:.3e} "
          f"in norm ({worst}); Top1 correct card {tops} cpu {tops_cpu}; "
          f"{'within' if ok else 'BEYOND'} the bounds")
    if not ok:
        raise RuntimeError("the LeNet card trajectory differs from the "
                           "CPU's beyond the stated bounds")
    return dict(eager=eager["out"], graph=graph["out"],
                eager_busy=eager["busy"], graph_busy=graph["busy"],
                eager_peak=eager["peak"], graph_peak=graph["peak"],
                parity=(loss_rel, norm_rel[worst]))


# each path of the dispatch phase: its perf argv and the kernels it
# launches, with their launches per step
DISPATCH_PATHS = {
    "lm": (TRAIN_ARGV, {n: LAYERS for n in ("flash_attention_fwd",
                                            "flash_attention_dq",
                                            "flash_attention_dkv")}),
    "sp": (TRAIN_ARGV, {n: LAYERS * SP_PAIRS for n in (
        "flash_attention_partial", "flash_attention_dq_partial",
        "flash_attention_dkv_partial")}),
    "resnet": (RESNET_ARGV, RESNET_LAUNCHES),
}

# for each wrapper, the device kernel that each of its launches on the
# bf16 training paths runs exactly once (its tensor-core route; #4 its
# only kernel), by parts of the demangled name torch.profiler reports
KERNEL_EVENTS = {
    "flash_attention_fwd": ("flash_fwd_tc_kernel<false",),
    "flash_attention_dq": ("flash_dq_tc_kernel<", ", false>"),
    "flash_attention_dkv": ("flash_dkv_tc_kernel<",),
    "flash_attention_dbias": ("flash_dbias_kernel",),
    "flash_attention_partial": ("flash_fwd_tc_kernel<true",),
    "flash_attention_dq_partial": ("flash_dq_tc_kernel<", ", true>"),
    "flash_attention_dkv_partial": ("flash_dkv_partial_tc_kernel<",),
    "matmul_bn_fwd": ("tcconv::fprop<1>",),
    "matmul_bn_bwd": ("tcconv::wgrad<1>",),
    "conv3x3_bn_fwd": ("tcconv::fprop<9>",),
    "conv3x3_bn_bwd": ("tcconv::wgrad<9>",),
}

# the kernel of torch.cuda._sleep, which marks the end of a capture on
# the device (mark_captures)
MARKER = "spin_kernel"


def mark_captures(opt):
    """Follow each of ``opt``'s graph captures with a marker kernel on the
    current stream.  The warm-up step before a capture ran before the
    marker on the device (the stream waited for it), the capture launched
    nothing, and the replays run after it: so the device events after the
    marker are the replays'."""
    capture = opt._capture

    def marked(*args):
        step_graph = capture(*args)
        torch.cuda._sleep(1)
        return step_graph
    opt._capture = marked


def kernel_launches(events):
    """{wrapper: its kernel's events among ``events``}, by KERNEL_EVENTS."""
    return {name: sum(all(part in e.name for part in parts) for e in events)
            for name, parts in KERNEL_EVENTS.items()}


def dispatch_model(path):
    """The path's model as its phase builds it."""
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(DISPATCH_PATHS[path][0])
    model, criterion, make_batch = perf.build(args.model, args)
    if path == "sp":
        model.lm.set_sequence_parallel(seq_mesh(), "seq")
    return args, model, criterion, make_batch


def dispatch_reading(path, k):
    """One timed run of the path with windows of ``k`` (1: eager) under
    ``torch.profiler``: its ms per iteration, peak memory, the wrappers'
    counts, and from the run's own device events its busy time and each
    kernel's launches before the capture's marker and after it (the
    replays')."""
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.examples import perf
    args, model, criterion, make_batch = dispatch_model(path)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, opt = perf.run(args, model, criterion, make_batch,
                            configure=dispatch_of(k, mark_captures))
        torch.cuda.synchronize()
    launches, routes = _read_counts(), _read_routes()
    peak = torch.cuda.max_memory_allocated()
    events = device_events(prof)
    marks = [i for i, e in enumerate(events) if MARKER in e.name]
    cut = marks[0] if marks else len(events)
    steps = args.iterations * args.epochs
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if MARKER not in e.name)
    return dict(out=out, opt=opt, model=model, launches=launches,
                routes=routes, peak=peak, marks=len(marks),
                busy=busy_us / device_steps(opt, steps) / 1e3,
                ran=device_steps(opt, steps),
                before=kernel_launches(events[:cut]),
                replayed=kernel_launches(events[cut + 1:]),
                steps=steps, iterations=args.iterations)


def phase_dispatch():
    """The LM, the SP LM and ResNet-50 at their smoke configurations,
    each eagerly and with windows of an epoch's iterations (no window
    trimmed: CUDA graph replays), deterministic algorithms on for both,
    each run under torch.profiler: the losses and parameters must be
    equal bit for bit, and the graph run's device events must show each
    kernel launched a step's worth per replay."""
    readings = {}
    with deterministic() as nondet:
        for path in DISPATCH_PATHS:
            eager = dispatch_reading(path, 1)
            graph = dispatch_reading(path, eager["iterations"])
            readings[path] = (eager, graph)
            _dispatch_report(path, eager, graph)
    print(f"dispatch: operations without a deterministic implementation: "
          f"{sorted(nondet) or 'none'}")
    return {path: dict(eager_ms=e["out"]["ms_per_iteration"],
                       graph_ms=g["out"]["ms_per_iteration"],
                       eager_busy=e["busy"], graph_busy=g["busy"],
                       eager_peak=e["peak"], graph_peak=g["peak"],
                       replayed=g["replayed"],
                       replays=g["opt"].dispatch_stats["replays"])
            for path, (e, g) in readings.items()}


def _dispatch_report(path, eager, graph):
    _, per_step = DISPATCH_PATHS[path]
    steps = eager["steps"]
    for label, r in (("eager", eager), ("graph", graph)):
        print(f"dispatch {path}: {label}: {r['out']['ms_per_iteration']} "
              f"ms/iteration (steady windows, under torch.profiler), "
              f"{r['out']['records_per_sec']} records/s; device busy "
              f"{r['busy']:.3f} ms per step ({r['ran']} steps on the "
              f"device), idle share "
              f"{1 - r['busy'] / r['out']['ms_per_iteration']:.3f}; peak "
              f"memory {r['peak']} bytes; dispatch "
              f"{r['opt'].dispatch_stats}; wrapper counts "
              + ", ".join(f"{n} {r['launches'][n]}" for n in per_step)
              + "; device launches "
              + ", ".join(f"{n} {r['before'][n]}" for n in per_step)
              + ("" if label == "eager" else
                 " before the capture's marker (the warm-up step), "
                 + ", ".join(f"{n} {r['replayed'][n]}" for n in per_step)
                 + f" after it ({steps} replays)"))
    same_losses = eager["opt"].loss_history == graph["opt"].loss_history
    gap = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(
        graph["opt"].loss_history, eager["opt"].loss_history))
    same_params = all(torch.equal(p, q) for p, q in zip(
        eager["model"].parameters(), graph["model"].parameters()))
    same_buffers = all(torch.equal(p, q) for p, q in zip(
        eager["model"].buffers(), graph["model"].buffers()))
    print(f"dispatch {path}: graph against eager over {steps} steps: "
          f"losses {'equal' if same_losses else 'DIFFER'} (worst "
          f"{gap:.3e} relative), parameters "
          f"{'equal' if same_params else 'DIFFER'}, buffers "
          f"{'equal' if same_buffers else 'DIFFER'} bit for bit")
    if not (same_losses and same_params and same_buffers):
        raise RuntimeError(f"dispatch {path}: the graph run is not the "
                           "eager run")
    want_stats = {"single_steps": 0, "window_steps": steps, "captures": 1,
                  "replays": steps}
    if graph["opt"].dispatch_stats != want_stats:
        raise RuntimeError(f"dispatch {path}: {graph['opt'].dispatch_stats}"
                           f" != {want_stats}")
    if eager["marks"] != 0 or graph["marks"] != 1:
        raise RuntimeError(f"dispatch {path}: {eager['marks']} and "
                           f"{graph['marks']} capture markers on the "
                           "device, not 0 and 1")

    def expect(what, got, n_steps):
        want = {n: per_step.get(n, 0) * n_steps for n in got}
        if got != want:
            raise RuntimeError(f"dispatch {path}: {what}: {got}, not "
                               f"{want}")
    # the wrappers count what their Python launched: every eager step,
    # and in the graph run the warm-up step and the capture
    expect("the eager run's wrapper counts", eager["launches"], steps)
    expect("the graph run's wrapper counts", graph["launches"], 2)
    for label, r, n in (("eager", eager, steps), ("graph", graph, 2)):
        for name in per_step:
            _check_routes(r["routes"], name,
                          {"tensor_core": per_step[name] * n, "scalar": 0},
                          f"dispatch {path} {label} run")
    # the device ran each kernel once a launch: every eager step's, the
    # warm-up step's before the marker and a step's worth per replay
    # after it
    expect("the eager run's device launches", eager["before"], steps)
    expect("the graph run's device launches before the capture's marker",
           graph["before"], 1)
    expect("the graph run's device launches after the capture's marker",
           graph["replayed"], graph["opt"].dispatch_stats["replays"])


def _kernel_entry(name, source, replaces, launches, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["what"]}


def step_reading(path: str, dispatch: int = 1) -> dict:
    """The timed training run of one path alone ("resnet": phase 9's,
    "sp": phase 7b's, "lm": phase 6's), without its launch and route
    checks and without the profiler, so that the same measurement runs
    on any checkout of the port: from that checkout's root, ``python3
    chip_smoke.py --step resnet|sp|lm [--dispatch k]`` (k > 1: windows
    of k steps, CUDA graph replays on a checkout that has them).  Prints
    and returns its steady ms per iteration, peak memory and device busy
    ms per step (profile_steps, a short run after it) as one JSON
    object."""
    from bigdl_tpu_torch.examples import perf
    if path not in DISPATCH_PATHS:
        raise ValueError(f"--step takes resnet, sp or lm, not {path!r}")
    args, model, criterion, make_batch = dispatch_model(path)
    # left out for k=1: an older checkout's perf.run takes no configure
    kw = {} if dispatch == 1 else {"configure": dispatch_of(dispatch)}
    torch.cuda.reset_peak_memory_stats()
    out, _ = perf.run(args, model, criterion, make_batch, **kw)
    peak = torch.cuda.max_memory_allocated()
    busy = profile_steps(args, model, criterion, make_batch,
                         configure=None if dispatch == 1 else dispatch_of(
                             min(dispatch, BUSY_ITERS)))
    reading = {"step": path, "dispatch": dispatch,
               "ms_per_iteration": out["ms_per_iteration"],
               "peak_memory_bytes": peak, "device_busy_ms_per_step": busy,
               "idle_share": 1 - busy / out["ms_per_iteration"]}
    print(json.dumps(reading))
    return reading


def main() -> int:
    if sys.argv[1:2] == ["--step"]:
        phase_device()
        dispatch = (int(sys.argv[4]) if sys.argv[3:4] == ["--dispatch"]
                    else 1)
        step_reading(sys.argv[2], dispatch)
        return 0
    t0 = time.perf_counter()
    smi = phase_device()
    rates = card_rates(torch.cuda.get_device_name(0))
    tc_build = phase_build()
    shapes = phase_kernel_checks(rates)
    bwd = phase_bwd_kernel_checks(rates)
    ring = phase_partial_kernel_checks(rates)
    conv = phase_conv_kernel_checks(rates)
    serving, serving_routes = phase_serving()
    train = phase_training()
    phase_train_parity()
    sp = phase_sp_training()
    phase_sp_parity()
    resnet = phase_resnet_training()
    phase_fused_vs_plain()
    phase_resnet_parity()
    phase_lenet()
    dispatch = phase_dispatch()
    by_path = {"serving": serving, "lm_training": train["launches"],
               "sp_training": sp["launches"],
               "resnet_training": resnet["launches"],
               # the replays' launches, from the graph runs' device events
               **{f"{path}_graph_replays": r["replayed"]
                  for path, r in dispatch.items()}}

    def paths(name):
        return {path: counts[name] for path, counts in by_path.items()}

    def row(rows, kernel, shape):
        return next(r for r in rows
                    if r["kernel"] == kernel and r["shape"] == shape)

    csrc = "bigdl_tpu_torch/ops/csrc/"
    fwd = _kernel_entry(
        "flash_attention_fwd", csrc + "flash_attention_fwd.cu",
        "bigdl_tpu/ops/attention_kernels.py:264",
        serving["flash_attention_fwd"],
        next(s for s in shapes if s["shape"] == "b_decode"))
    # beside the serving path's decode row, the LM training path's row
    at_train = next(s for s in shapes if s["shape"] == "f_train")
    fwd["at_training_shape"] = dict(
        _kernel_entry("flash_attention_fwd", fwd["source"], fwd["replaces"],
                      train["launches"]["flash_attention_fwd"], at_train),
        kernel_route=at_train["route"], scalar_ms=at_train["scalar_ms"],
        ms_per_training_step=train["kernel_ms_per_step"][
            "flash_attention_fwd"])
    fwd["shapes"] = shapes
    kernels = [fwd]
    for name, replaces, shape in (
            ("dq", "bigdl_tpu/ops/attention_kernels.py:483", "t_train"),
            ("dkv", "bigdl_tpu/ops/attention_kernels.py:515", "t_train"),
            ("dbias", "bigdl_tpu/ops/attention_kernels.py:549",
             "v_bias_b1tt")):
        entry = _kernel_entry(
            f"flash_attention_{name}", csrc + "flash_attention_bwd.cu",
            replaces, train["launches"][f"flash_attention_{name}"],
            row(bwd, name, shape))
        entry["ms_per_training_step"] = train["kernel_ms_per_step"].get(
            f"flash_attention_{name}")
        entry["shapes"] = [r for r in bwd if r["kernel"] == name]
        kernels.append(entry)
    for name, source, line in (
            ("partial", "flash_attention_fwd.cu", 674),
            ("dq_partial", "flash_attention_bwd.cu", 787),
            ("dkv_partial", "flash_attention_bwd.cu", 829)):
        full = f"flash_attention_{name}"
        entry = _kernel_entry(
            full, csrc + source, f"bigdl_tpu/ops/attention_kernels.py:{line}",
            sp["launches"][full], row(ring, name, "offdiag_bf16"))
        entry["ms_per_training_step"] = sp["kernel_ms_per_step"][full]
        entry["shapes"] = [r for r in ring if r["kernel"] == name]
        kernels.append(entry)
    for name, source, line, shape in (
            ("matmul_bn_fwd", "conv_bn_fwd.cu", 274, "s1_conv3"),
            ("matmul_bn_bwd", "conv_bn_bwd.cu", 317, "s1_conv3"),
            ("conv3x3_bn_fwd", "conv_bn_fwd.cu", 668, "s1_conv2"),
            ("conv3x3_bn_bwd", "conv_bn_bwd.cu", 708, "s1_conv2")):
        entry = _kernel_entry(
            name, csrc + source, f"bigdl_tpu/ops/conv_bn_kernels.py:{line}",
            resnet["launches"][name], row(conv, name, shape))
        entry["ms_per_training_step"] = resnet["kernel_ms_per_step"][name]
        entry["shapes"] = [r for r in conv if r["kernel"] == name]
        kernels.append(entry)
    for entry in kernels:
        entry["launches_by_path"] = paths(entry["name"])
    # the kernels redesigned for the tensor cores: their design, their
    # launches by route on each path and their build report
    routes_by_path = {"serving": serving_routes,
                      "lm_training": train["routes"],
                      "sp_training": sp["routes"],
                      "resnet_training": resnet["routes"],
                      # by the tensor-core kernel each replay ran
                      **{f"{path}_graph_replays": {
                          n: {"tensor_core": c}
                          for n, c in r["replayed"].items()}
                         for path, r in dispatch.items()}}
    for name, design in (
            ("flash_attention_fwd",
             "tensor cores for bf16 with 16-byte rows (mma.sync.m16n8k16 "
             "bf16->f32, #5's FlashAttention-2 forward loop from a fresh "
             "state: 64 query rows per block, heaviest blocks first, Q "
             "fragments in registers, 64-key K/V tiles through two "
             "cp.async stages, the f32 bias through its strides, P "
             "rounded to bf16 from the S fragments, out = acc / l and lse "
             "in the epilogue); scalar f32 FMAs for f32 (serving)"),
            ("flash_attention_dq",
             "tensor cores for bf16 (mma.sync.m16n8k16 bf16->f32, #1's "
             "FlashAttention-2 loop turned to dQ: 64 query rows per block, "
             "heaviest blocks first, Q and dO fragments, lse, Delta and the "
             "dQ sum in registers, 32-key K/V tiles (64 at D32) through two "
             "cp.async stages, S and dP on the tensor cores, dS rounded to "
             "bf16 and repacked from the C into A fragments, dQ += dS.K "
             "with K through ldmatrix.trans); scalar f32 FMAs for f32"),
            ("flash_attention_dkv",
             "tensor cores for bf16 (mma.sync.m16n8k16 bf16->f32, "
             "FlashAttention-2 dK/dV: 64 keys per block, 32-query tiles "
             "through two cp.async stages, P and dS from registers); "
             "scalar f32 FMAs for f32"),
            ("flash_attention_partial",
             "tensor cores for bf16 with 16-byte rows (mma.sync.m16n8k16 "
             "bf16->f32, the FlashAttention-2 forward loop: 64 query rows "
             "per block with Q fragments in registers, 64-key K/V tiles "
             "through two cp.async stages, P rounded to bf16 from the S "
             "fragments, the carried state in the C fragments); scalar "
             "f32 FMAs for f32"),
            ("flash_attention_dkv_partial",
             "tensor cores for bf16 q/k/v with 16-byte rows (mma.sync."
             "m16n8k16 bf16->f32, #3's dK/dV structure with dO in f32: "
             "dO's tile split in shared memory and P in registers into "
             "three bf16 pieces each, whose sum is exact; dP over dO's 3 "
             "pieces, dV over 6 cross terms down to 2^-24, each 16-deep "
             "step summed into a fresh tile; 11 bf16 products where the "
             "scalar kernel does 4 in f32); scalar f32 FMAs for f32"),
            ("flash_attention_dq_partial",
             "tensor cores for bf16 q/k/v with 16-byte rows (mma.sync."
             "m16n8k16 bf16->f32, #2's loop with dO in f32: "
             "flash_dq_tc_kernel<D, true>, 64 query rows per block, "
             "heaviest first, dO's rows split once into three bf16 pieces "
             "whose sum is exact (held in registers up to D64), dP over "
             "the 3 pieces smallest first, each 16-deep step summed into a "
             "fresh tile, dS rounded to bf16 for dQ += dS.K; 5 bf16 "
             "products where the scalar kernel does 3 in f32); scalar f32 "
             "FMAs for f32"),
            ("conv3x3_bn_fwd",
             "tensor cores for bf16 (a prepass storing z and a padded W "
             "once, then the 3x3 as an implicit GEMM on mma.sync."
             "m16n8k16 bf16->f32, 128x64 tiles, three cp.async stages, "
             "zero-filled halo, statistics of the rounded y in a fixed "
             "order); scalar f32 FMAs for f32"),
            ("matmul_bn_fwd",
             "tensor cores for bf16 (#10's route with one tap: a prepass "
             "storing z only with a norm or K % 64 != 0 (else x is read in "
             "place) and a padded W only where K or N is not a multiple of "
             "64, then fprop<1> as an implicit GEMM on mma.sync.m16n8k16 "
             "bf16->f32, 128x64 tiles, 8 warps, three cp.async stages, y "
             "rounded to bf16 and the statistics of the rounded y in a "
             "fixed order); scalar f32 FMAs for f32"),
            ("matmul_bn_bwd",
             "tensor cores for bf16 (#11's route with one tap: a prepass "
             "storing z (none: x itself without a norm at K % 64 == 0), "
             "dyl folded from the forward's saved y (none: dy itself "
             "without statistics at N % 64 == 0) and a padded W; then "
             "one-tap dgrad and wgrad on mma.sync.m16n8k16 bf16->f32, "
             "128x64 tiles, three cp.async stages, dW split over rows and "
             "summed in order); scalar f32 FMAs for f32"),
            ("conv3x3_bn_bwd",
             "tensor cores for bf16 (a prepass storing z and dyl once, "
             "then dgrad and wgrad as implicit GEMMs on mma.sync."
             "m16n8k16 bf16->f32, 128x64 tiles, three cp.async stages, "
             "zero-filled halo); scalar f32 FMAs for f32")):
        entry = next(e for e in kernels if e["name"] == name)
        library, parts = TC_BUILD[name]
        entry["design"] = design
        entry["launches_by_route"] = {
            path: r[name] for path, r in routes_by_path.items()
            if sum(r[name].values())}
        entry["build"] = {k: r for k, r in tc_build[library].items()
                          if any(part in k for part in parts)}
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
