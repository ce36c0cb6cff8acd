#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card

Phases, each raising on failure (the script then exits non-zero):

1. device: the card's name, its ``nvidia-smi`` name and power limit, and
   the TF32 settings (f32 matmuls are set to full f32);
2. build: the CUDA flash-attention kernel from the checkout's sources;
3. the kernel against its plain PyTorch version at the serving path's
   shapes, with times (CUDA events, median of 60 runs, L2 flushed before
   each): the kernel, the plain version, ``scaled_dot_product_attention``
   with the same additive mask (a yardstick the port never calls) and
   the card's bound for the same work;
4. serving: a TransformerLM at the width of the largest LM the repo
   serves (vocab 32000, hidden 512, 6 layers, 8 heads, filter 1024,
   max_len 512; random weights from a seed) behind ``ModelServer`` and
   the continuous-batching engine with 128-wide prefill chunks, 32
   requests; every served row is held against a solo ``generate()`` and
   the kernel's launch count against the path's attention calls;
5. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports torch, numpy and ``bigdl_tpu_torch`` only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def phase_build():
    from bigdl_tpu_torch.ops.build import build_library, load_library
    t0 = time.perf_counter()
    load_library("flash_attention_fwd")
    print(f"build: flash_attention_fwd.cu built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    report = build_library("flash_attention_fwd").with_suffix(".ptxas.txt")
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())


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
    """The five shapes of the serving path and its edges."""
    from bigdl_tpu_torch.nn.attention import (chunk_incremental_bias,
                                              incremental_bias)
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


def phase_kernel_checks(rates):
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.attention_kernels import (
        dot_product_attention, plain_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    with torch.no_grad():
        for key, desc, (q, k, v, bias, causal), tol in _inputs(gen):
            out = dot_product_attention(q, k, v, bias, causal=causal)
            ref = plain_attention(q, k, v, bias, causal=causal)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{key}: kernel output is not finite")
            err = float((out.float() - ref.float()).abs().max())
            if not torch.allclose(out.float(), ref.float(), **tol):
                raise RuntimeError(f"{key}: kernel disagrees with the plain "
                                   f"version (max abs err {err:.3e}, "
                                   f"tolerance {tol})")
            mask = _sdpa_mask(q, k, bias, causal)
            row = {
                "shape": key, "what": desc, "max_abs_err": err,
                "ms": time_ms(lambda: dot_product_attention(
                    q, k, v, bias, causal=causal), flush),
                "plain_ms": time_ms(lambda: plain_attention(
                    q, k, v, bias, causal=causal), flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), flush),
            }
            row["bound_ms"], row["bound_by"] = bound(q, k, v, bias, causal,
                                                     rates)
            results.append(row)
            print(f"kernel {key:16s} {desc:40s} max_abs_err {err:.3e}  "
                  f"kernel_ms {row['ms']:.5f}  plain_ms "
                  f"{row['plain_ms']:.5f}  library_ms "
                  f"{row['library_ms']:.5f}  bound_ms "
                  f"{row['bound_ms']:.5f} ({row['bound_by']})")
    return results


# ---------------------------------------------------------------------------
# 4. serving at full width
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
    from bigdl_tpu_torch.ops.attention_kernels import flash_attention_fwd
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
    flash_attention_fwd.launches = 0
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
    launches = flash_attention_fwd.launches
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
    return launches


def main() -> int:
    smi = phase_device()
    rates = card_rates(torch.cuda.get_device_name(0))
    phase_build()
    shapes = phase_kernel_checks(rates)
    launches = phase_serving()
    decode = next(s for s in shapes if s["shape"] == "b_decode")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "bigdl_tpu/ops/attention_kernels.py:264",
        "launches": launches,
        "max_abs_err": decode["max_abs_err"],
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": decode["what"],
        "shapes": shapes,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
