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
   (``fwd_held``) and timed beside the scalar template; the mixed entry
   (f32 q, bf16 K/V: a bf16 KV cache) at the decode and chunk shapes,
   held by ``mixed_held`` (an f32 rule with an f64 anchor), timed beside
   the scalar route on the same K/V upcast, SDPA on K/V upcast and the
   upcast's copy; the teacher-forced bf16 translation forward's
   three calls (encoder T128 and cross-attention Tq64 Tk128 under a
   padding bias broadcast over Tq, decoder T64 under a causal bias), in
   the model's head layout, held by ``fwd_held``; and the decodes no row
   above covers (the beam_lm decode B32 Tk160 under a left-padded bias, a
   one-request decode B1 Tk512 in f32 and mixed, the translation's
   cross-attention decode B32 Tk128 in the model's head layout).  Every
   row names the kernel it ran (f32 q with 16-byte rows: the decode
   kernel at Tq 1, the tile kernel beyond) and is timed beside the
   scalar template on the same inputs, with its share of the bound; then
   a row held bit for bit among others, alone and over a Tk extended by
   keys its bias masks (``row_independence``: a decode row among 16
   slots, a chunk row among 9 requests and alone, f32 and mixed);
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
   launch by the scalar route (f32), the decode steps on #1's decode
   kernel and the prefill calls on its tile kernel (``kernels_held``;
   the prefix, oneshot and beam phases check theirs the same way);
5b. prefix: the same LM through the prefix KV cache (granularity 64):
   ``run_shared_prefix_workload`` with 32 requests on a 256-token shared
   prefix and tails of 8-64, cache on and off (TTFT p50/p99, prefill
   calls and seconds, chunks copied, hit rate, peak memory), the rows of
   the two runs and two rows against solo ``generate()`` held by the
   serving rule (equal, or first different at a top-2 margin under
   NEAR_TIE), #1's launches = layers x (prefill and chunk calls + decode
   steps), all scalar; eviction under a budget of three chunks with two
   alternating 256-token prefixes; a burst of 8 identical cold 257-token
   prompts (1 leader, 7 followers, the prefill calls of one prompt);
   ``DisaggregatedEngine`` (4 prefill slots, 16 decode slots) against one
   engine on 16 requests; a chunk extracted from a decoding slot and
   copied into a free slot after the slot's reuse, bit for bit; a
   ``Deadline(0.25)`` under a paced stream failing typed; ``kill()``
   failing residents with ReplicaDeadError and queued requests with
   ServerClosedError.  A failed check prints ``prefix: FAILED: <check>``;
5c. oneshot: the same LM one-shot, ``ModelServer(backend=lm,
   max_batch=16, batch_timeout_ms=5)`` after ``warmup`` on a 128-token
   row: 64 requests of 128 tokens from 8 threads released together, a
   burst of 16 through ``submit_many``, 3 lone requests; every reply
   ([128, vocab + 1] logits) within F32_TOL of the LM's forward of its
   row alone on the card, the same argmax bar a near-tie, 83 requests in
   the metrics, #1 at layers x (batches + 5 warm-up buckets) launches,
   all scalar; requests/s, latency quantiles, batches, padded waste, a
   full bucket's device and readback ms, peak memory.  Then ResNet-50 in
   eval mode (f32, BatchNorm scales and statistics from a seed) through
   ``Predictor(batch_size=32)`` at the entry's ones batch and 40 random
   images, ``predict_class``, ``Evaluator`` (Top1, Top5, Loss: 40
   samples), a ``PredictionService`` from 4 threads with a
   ``predict_bytes`` round trip and ``serve()``, all against a CPU copy
   (1e-4 of max |logit|), no kernel launched; images/s at batch 32.  A
   failed check prints ``oneshot: FAILED: <check>``;
5d. beam: the same LM's ``generate_beam`` (8 prompts of 16-128 tokens
   left-padded to 128, beam 4, 32 new tokens, alpha 0.6) with no EOS and
   with an EOS it emits, each against a CPU copy (``beams_held``: every
   top-k decision equal, or the first different one at a near-tie;
   scores within F32_TOL of the largest logit), beam 1 against greedy
   ``generate()`` (``rows_held``), #1 at 32 rows, scalar; the
   Transformer-base translation model (6 + 6 layers, filter 2048, vocab
   32000) encoding 8 sources of 16-128 tokens and searching (beam 4, 64
   steps) over ``decode_step`` with the cross-attention cache, against a
   CPU copy, ``decode_step`` against ``decode()`` (F32_TOL), a timed
   teacher-forced bf16 forward (#1 on the tensor cores with a padding
   bias, Tq != Tk); the 32 serving requests and the shared-prefix
   requests with a bf16 KV cache under the f32 LM (#1's ``mixed_kv``
   route on every decode step and chunk prefill), rows against a CPU
   engine with the same cache and prefix cache on against off, the
   pool's bytes half the f32 pool's.  #1's launches by route equal
   layers x the calls each path made.  A failed check prints ``beam:
   FAILED: <check>``;
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
13b. resume: the LM of phase 6 through the Optimizer for 3 epochs of 4
   distinct shuffled batches in windows of 2 (graph replays),
   deterministic algorithms on, uninterrupted and again with every-epoch
   checkpoints (keep 2), failure retry, the 2nd checkpoint torn and a
   failure injected at iteration 11: the retry must walk back to
   generation 5 and end with the uninterrupted run's loop state, its
   losses after the resume point, parameters and SGD state bit for bit,
   with a fresh capture; #1-#3 by the tensor-core route, their warm-up
   and replay launches read from each run's device events between marker
   kernels around each capture; the checkpoint's bytes, write and load
   ms beside the card's name and power limit.  A failed check prints
   ``resume: FAILED: <check>`` before the script exits non-zero;
13c. remat: the LM of phase 6 with dropout 0.1 after the attention and
   in the FFN, 2 epochs of 4 distinct batches, deterministic algorithms
   on, eagerly, with ``remat`` eagerly and with ``remat`` in windows of 4
   (graph replays): the three runs' losses and parameters equal bit for
   bit; #1/#2/#3 at 6/6/6 launches a step without remat and 12/6/6 with
   it (the forward kernel again in each block's recompute), by the
   tensor-core route, counted by the wrappers eagerly and from the device
   events in the graph run (the warm-up step between marker kernels, the
   replays after them); ms per iteration and peak memory of each;
13d. prefetch: ResNet-50 of phase 9 on 4 distinct host-resident batches
   (not cached on the card) for 3 epochs, eagerly, without device
   prefetch and with ``set_device_prefetch(2)``: losses, parameters and
   buffers equal bit for bit, 12 batches staged ahead, #8-#11 at
   32/32/13/13 a step, no ``bigdl-device-prefetch`` thread left; the
   bytes staged a step, ms per iteration, the device's busy ms and idle
   share a step and its host-to-device copy ms, for both;
13e. drain: LeNet-5 of phase 12 for 2 epochs of 50 with every loss read,
   with the asynchronous loss drain (no trigger reads the loss) and
   synchronously (``end_when`` OR'ed with ``Trigger.min_loss(-1.0)``):
   the loss histories, parameters and ``dispatch_stats`` equal bit for
   bit, 100 window timings each, the async run's losses read on the
   ``bigdl-loss-drain`` thread and none left after it; ms per iteration
   and idle share of both.  Each of 13c-13e prints ``<phase>: FAILED:
   <check>`` for a failed check before the script exits non-zero;
13f. zoo_training: the models the perf CLI gained, through
   ``examples.perf``: ``--model inception-v1``, ``inception-v2`` and
   ``vgg16`` at phase 9's shape (b128, 224 px, 1000 classes, bf16), 10
   iterations x 3 epochs each, losses finite (the trajectory, ms per
   iteration, images/s, peak memory, the device's busy ms and idle share
   printed); the PTB LSTM LM at the defaults of the repo's
   ``bigdl-tpu-ptb`` (b32, 20 steps, vocab 10000, hidden 200, 2 layers,
   f32) eagerly and with windows of an epoch (graph replays),
   deterministic algorithms on for both: losses and parameters equal bit
   for bit (ms per iteration, tokens/s, busy and idle of both); one f32
   step of each of the four models on the card against a CPU copy (the
   image models by phase 11's bounds where float32 is stable:
   Inception-v1 at 64 px, batch 4, Inception-v2 at 32 px, batch 8, its
   BatchNorm biases from U(-0.5, 0.5), VGG-16 at 224 px, batch 2, its
   weights at He's variance; PTB at its size by phase 7's; TF32 off);
   every run launches none of #1-#11.  A
   failed check prints ``zoo_training: FAILED: <check>``;
13g. detection: TF32 set off and checked; the gate (``detection_gate``):
   planted NMS rows (IoU exactly at the threshold, tied scores with the
   pre-top-k cut among them, all -inf rows, fewer boxes than slots)
   through the port's ``nms`` on the card against a numpy copy of the
   reference's loop, DetectionOutputSSD over tied scores at SSD-300's
   width against the reference's per-image loop, fc6's dilated and the
   mask head's transposed convolution (and a grouped one with adj 1)
   against their definitions, and the planted boxes of
   tests/test_detection.py at VOC mAP 1.0; SSD-300 VGG16 (21 classes,
   He-scaled random weights, f32) through ``Predictor(batch_size=32)``
   over 128 images (images/s, a batch's device busy and idle share, its
   device split into VGG + heads, prior decode and NMS / top-k, NMS
   calls and loop steps per batch, peak memory), a batch's heads against
   a CPU copy (DET_FEATURE_REL in norm), its rows against the CPU path
   fed the card's loc and conf (``detections_held``: equal but near-tie
   rows) and against the reference's loop on the card's decoded boxes
   (equal), a forward under ``host_ops`` (no host read, no host
   tensor), and 64 single-image requests through
   ``ModelServer(backend=ssd, max_batch=32)``, each row against the
   image's solo forward; Mask R-CNN (81 classes, conditioned on its
   image: ``maskrcnn_model``) on one 800 x 1088 image (ms per image, the
   device split into backbone + FPN, RPN + its NMS, Pooler / RoiAlign,
   box head + its NMS and mask head, NMS calls, peak memory), every
   stage against the CPU copy fed the card's previous stage, a forward
   under ``host_ops``; #1-#11 at 0 launches.  A failed check prints
   ``detection: FAILED: <check>``;
13h. methods: TF32 off; every method of ``optim/methods.py`` (SGD,
   Adam, ParallelAdam, Adagrad, Adadelta, Adamax, RMSprop, Ftrl, LarsSGD,
   LBFGS) on LeNet-5 (b256, f32, 10 distinct batches, deterministic
   algorithms on) eagerly on the card against a CPU copy fed the same
   batches (each loss within METHOD_LOSS_RTOL, each parameter within
   METHOD_PARAM_NORM_REL in norm) and in windows of 4 (two replayed
   windows and a ragged tail of single steps) against the eager run bit
   for bit (losses, parameters, every state tensor); every schedule
   (Default to EpochSchedule) under SGD in windows, its rate tensor read
   back after every replay against the host's float32 sequence; Plateau
   told planted validation scores (two reductions and a cooldown), the
   rate each step read against the host's; the LM of phase 6 with
   ``Adam()`` through the Optimizer eagerly and in windows of 4, bit for
   bit (losses, parameters, Adam's state), #1-#3 at the SGD run's
   launches a step (wrapper counts eagerly, device events after the
   capture's marker in the windows), ms per iteration, busy time, peak
   memory, and Adam's update over the LM's parameters timed (CUDA events,
   kernels and busy ms from torch.profiler, its bound); ResNet-50 of
   phase 9 with the ImageNet recipe (SGD, nesterov momentum 0.9, a warm-up
   epoch then Poly(0.5)) in windows of an epoch, the rate each replay read
   equal to the host's and moving every step, #8-#11 at 32/32/13/13 a
   step on the device; the NCF example at MovieLens-1M's widths (6040
   users, 3706 items, embed 16, b256, 2 epochs; HitRatio@10 and NDCG@10
   above chance, samples/s) and the autoencoder example (``--synthetic
   6000 -b 150 -e 2``: the loss falls), neither launching #1-#11.  A
   failed check prints ``methods: FAILED: <check>``;
13i. int8: the int8 layers (``nn/quantized.py``) at ResNet-50's and
   SSD-300's shapes (INT8_ROWS: the 7x7/2 stem, a 1x1, a 3x3/2, fc6
   dilated 6, the 1000-way head at b32 and a b1 1-D input), each on the
   card's ``_int_mm`` path and its float64 plain version: ``qweight``,
   ``wscale``, the int8 activations and the int32 sums equal the CPU
   copy's and the plain version's bit for bit, the output the plain
   version's and within 1 ulp of the CPU's; times (CUDA events, median
   of 60, L2 flushed) beside the f32 layer's and the int8 bound;
   ``perf --int8-infer`` (ResNet-50 b32 224 px) against the f32 and
   the bf16 baseline, peak memory; int8 against f32 logits at b32
   (relative L2 under 0.05, top-1 agreement at least 0.75); the
   conditioned ResNet-50 int8 on the card against its CPU copy at b2
   (the stem's int8 activations equal, the differing entries by layer,
   logits within 1e-3 in norm); int8 SSD-300 through the Predictor at
   batch 32 (images/s, peak memory), its rows of 2 images against a CPU
   copy of the int8 model (``detections_held``) and the share of the f32
   model's kept detections it keeps; #1-#11 at 0 launches.  A failed
   check prints ``int8: FAILED: <check>``;
13j. layers_9c: TF32 off; every layer of the third tranche (the rest of
   ``nn/linear.py``, ``nn/pooling.py`` and ``nn/conv.py``,
   ``nn/table_ops.py``, ``BinaryTreeLSTM``) forward and backward on the
   card against a CPU copy (LAYERS_9C); the text classifier and the
   Tree-LSTM examples at their defaults on synthetic data, eagerly and
   in windows of 4 under deterministic algorithms (losses and
   parameters bit for bit, the loss falling), samples/s, ms a step, the
   idle share (a short run under ``traced()``) and peak memory; #1-#11
   at 0 launches.  A failed check prints ``layers_9c: FAILED: <check>``;
13k. recommender: TF32 off; ``zoo("wide_and_deep")`` at the id
   stream's scale (``synthetic_id_stream``'s defaults: 100M users, 1M
   items, batches of 4096; embed 16, tower (32, 16); 6.87 GB of tables on
   the card from a seeded CUDA generator); one step on the first batch
   (``rec_step_check``: each table's scatter lands at most one row per
   unique id, the user tables' nonzero gradient rows are the rows their
   scatters landed at the batch's unique users, no row the batch did not
   touch moves); 16 batches for 4 epochs (the tables on SGD(0.5), the
   tower on SGD(0.05), ``hybrid_optim_methods``) eagerly and in windows
   of 4 (CUDA graph replays) under deterministic algorithms, losses and
   parameters bit for bit, the loss finite and its last epoch's mean
   below the first's (ms a step, samples/s, peak memory, the busy and
   idle shares from a short traced run); ``StreamingRecEval`` HitRatio@10
   and NDCG@10 over 4096 slates of 1 + 100, stopped after 3 batches,
   round-tripped through JSON and resumed equal to the one-shot sweep;
   64 requests through ``RecommenderScorer`` with ``shard_affinity_key``
   sessions, each within F32_TOL of the solo forward; 10 steps at
   MovieLens-1M's widths on the card against a CPU copy, and the CPU's
   float32 against its float64 (REC_LOSS_RTOL, REC_PARAM_NORM_REL); no
   launch of #1-#11.  A failed check prints ``recommender: FAILED:
   <check>``;
13l. ops_9b: TF32 off; every op of ``ops/operations.py`` on the card
   against the CPU (OPS_TOL for a floating result, else equal) and the
   edge cases against their numpy definitions (floor and truncating
   division, half-even rounding, an out-of-range one-hot, top-k ties
   lower index first, a bucket boundary, gathers filled); the random ops
   by bounds and moments; the sparse layers and the control-flow
   modules forward and backward against a CPU copy (LAYER_TOL);
   ``dedup_gather``'s backward against the CPU (``dedup_held``); no
   launch of #1-#11.  A failed check prints ``ops_9b: FAILED: <check>``;
14. a ``{"kernels": [...]}`` line (eleven kernels, launches by path
   (#1's on ``serving_prefix_cache``, ``serving_disaggregated``,
   ``oneshot_lm``, ``beam_lm``, ``translation_beam`` and
   ``serving_bf16_kv`` too, and by kernel on each of them under
   ``launches_by_kernel``; its mixed entry's rows under ``mixed_kv``; its
   row-independence readings),
   the graph replays' among them (phases 13, 13b, 13c and 13h's ResNet-50)
   as the profiler counted them on the device, 13h's LM with Adam, and
   13f's and 13g's paths, 13h's LeNet and examples and 13i's, 13j's,
   13k's and 13l's paths at 0; all but #4 also their design, launches
   by route and build report; #1 its row at the training shape beside the decode row), then
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
import threading
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
        for kernel in getattr(w, "kernels", ()):
            w.kernels[kernel] = 0


def _read_counts():
    return {w.__name__: w.launches for w in _wrappers()}


def _read_routes():
    """{wrapper: {route: launches}} of the wrappers with two routes (#1,
    #2, #3, #5, #7, #9, #10 and #11: tensor cores for bf16, scalar for
    f32)."""
    return {w.__name__: dict(w.routes) for w in _wrappers()
            if hasattr(w, "routes")}


def _read_kernels():
    """{kernel: launches} of #1 by the kernel each launch ran: "decode"
    (Tq 1) and "tile" (Tq > 1) for f32 q with 16-byte rows,
    "scalar_template" for other f32 rows and unaligned bf16 ones,
    "tensor_core" for bf16."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    return dict(ak.flash_attention_fwd.kernels)


def kernels_held(kernels, steps, prefills, what, exact=True, tensor_core=0):
    """The failed checks of #1's launches by kernel on a path that made
    ``steps`` launches at Tq 1 (decode steps, in launches) and
    ``prefills`` at Tq >= 1 (prefill, chunk, encode and forward calls):
    none on the scalar template, ``tensor_core`` on the tensor cores, the
    rest on the decode and tile kernels, ``steps`` on decode and
    ``prefills`` on tile with ``exact`` (else a prefill chunk of one token
    may take decode), each non-zero where the path made such calls."""
    decode, tile = kernels["decode"], kernels["tile"]
    failed = []
    if kernels["scalar_template"] or kernels["tensor_core"] != tensor_core:
        failed.append(f"{what}: #1 ran the kernels {kernels}, not "
                      f"{tensor_core} tensor-core launches and none on the "
                      "scalar template")
    if decode + tile != steps + prefills or not (
            decode == steps if exact else steps <= decode):
        failed.append(f"{what}: #1 ran decode {decode} and tile {tile} "
                      f"times, not {steps} decode and {prefills} tile"
                      + ("" if exact else " (a one-token chunk on decode)"))
    if (steps and not decode) or (prefills and not tile):
        failed.append(f"{what}: #1 left the decode or the tile kernel out "
                      f"({kernels})")
    return failed


def routes_are(got, want) -> bool:
    """Whether a wrapper's route counts ``got`` are ``want`` exactly, a
    route left out of ``want`` taken no time (#1 has a third route,
    ``mixed_kv``, which most paths never take)."""
    return ({r: n for r, n in got.items() if n}
            == {r: n for r, n in want.items() if n})


def _check_routes(routes, name, want, what):
    """Raise unless wrapper ``name`` took the routes ``want`` exactly."""
    if not routes_are(routes[name], want):
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
# #1's kernels for f32 q, redesigned on the CUDA cores (PR 18), whose
# build reports are printed beside the tensor-core kernels'
F32_KERNELS = ("flash_decode_kernel", "flash_tile_kernel",
               "flash_merge_kernel")
TC_PRODUCTS = ("flash_dq_tc_kernel", "flash_dkv_tc_kernel",
               "flash_fwd_tc_kernel", "flash_dkv_partial_tc_kernel",
               "tcconv5fprop", "tcconv5dgrad", "tcconv5wgrad")
# each redesigned wrapper's kernels among them: (library, name parts)
TC_BUILD = {
    "flash_attention_fwd": ("flash_attention_fwd",
                            ("flash_fwd_tc_kernelILb0E", *F32_KERNELS)),
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
            if not any(k in kernel for k in TC_KERNELS + F32_KERNELS):
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
    fn()

    def calls():
        for _ in range(runs):
            fn()
    split = {}
    for e in traced_call(calls)[1]:
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
    path's shape, bf16 rows at the tensor-core route's edges: the padded
    LM's causal+padding bias, ragged Tq != Tk with D padded to 64, D36
    (rows not on 16 bytes: the scalar route) and the pooled decode; and
    the mixed entry (f32 q, bf16 K/V: a bf16 KV cache under the f32 LM) at
    the pooled decode and the chunk prefill; and the teacher-forced bf16
    translation forward's three calls (translation_reading), q, k and v
    laid out as the model's heads are ([B, T, H, D] transposed), under
    its biases: the encoder's self-attention and the cross-attention
    under a [B, 1, 1, Ts] padding bias broadcast over Tq, the decoder's
    self-attention under a causal bias.  Each group is drawn after the
    ones before it, so that earlier rows keep their inputs."""
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
    rows = [
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
        (MIXED_SHAPES[0], "S16 H8 Tq1 Tk512 D64 f32 q, bf16 K/V, per-slot "
         "bias", (rnd(SLOTS, 8, 1, 64), rnd(SLOTS, 8, MAX_LEN, 64, dtype=bf),
                  rnd(SLOTS, 8, MAX_LEN, 64, dtype=bf), bias_b, False),
         F32_TOL),
        (MIXED_SHAPES[1], "B1 H8 Tq128 Tk512 D64 f32 q, bf16 K/V, chunk "
         "bias", (rnd(1, 8, 128, 64), rnd(1, 8, MAX_LEN, 64, dtype=bf),
                  rnd(1, 8, MAX_LEN, 64, dtype=bf), bias_a, False),
         F32_TOL),
    ]

    def heads(b, t):
        # the model's layout: [B, T, H, D] seen as [B, H, T, D]
        return rnd(b, t, 8, 64, dtype=bf).transpose(1, 2)

    # the translation forward: sources of 16-SRC_LEN tokens, 0-padded
    src_lens = torch.randint(16, SRC_LEN + 1, (BEAM_ROWS,), generator=gen,
                             device=dev)
    src = (torch.arange(SRC_LEN, device=dev)[None, :]
           < src_lens[:, None]).long()
    bias_src = padding_bias(src)
    translation = [
        ("m_encoder_bf16", "B8 H8 T128 D64 bf16 padding bias (encoder)",
         (heads(BEAM_ROWS, SRC_LEN), heads(BEAM_ROWS, SRC_LEN),
          heads(BEAM_ROWS, SRC_LEN), bias_src, False), BF16_TOL),
        ("n_decoder_bf16", "B8 H8 T64 D64 bf16 causal bias (decoder)",
         (heads(BEAM_ROWS, TEACHER_TT), heads(BEAM_ROWS, TEACHER_TT),
          heads(BEAM_ROWS, TEACHER_TT), causal_bias(TEACHER_TT, bf, dev),
          False), BF16_TOL),
        ("o_cross_bf16", "B8 H8 Tq64 Tk128 D64 bf16 padding bias (cross)",
         (heads(BEAM_ROWS, TEACHER_TT), heads(BEAM_ROWS, SRC_LEN),
          heads(BEAM_ROWS, SRC_LEN), bias_src, False), BF16_TOL),
    ]
    # the main path's decode shapes no row above covers: the beam_lm decode
    # (8 prompts x beam 4, left-padded to BEAM_TP, 32 new tokens), a
    # one-request decode in f32 and mixed, and the translation's
    # cross-attention decode in the model's head layout
    beams = BEAM_ROWS * BEAM_SIZE
    tk_beam = BEAM_TP + BEAM_NEW
    lens = torch.randint(BEAM_PROMPT[0], BEAM_PROMPT[1], (beams,),
                         generator=gen, device=dev)
    toks = (torch.arange(tk_beam, device=dev)[None, :]
            >= (BEAM_TP - lens)[:, None]).long()
    index_one = torch.randint(0, MAX_LEN, (1,), generator=gen, device=dev)
    bias_one = incremental_bias(
        MAX_LEN, index_one, torch.zeros((1, MAX_LEN), dtype=torch.bool,
                                        device=dev))
    cross_bias = bias_src.repeat_interleave(BEAM_SIZE, 0)

    def heads_f32(b, t):
        return rnd(b, t, 8, 64).transpose(1, 2)

    decodes = [
        ("p_beam_decode", "B32 H8 Tq1 Tk160 D64 f32 left-padded bias (beam)",
         (rnd(beams, 8, 1, 64), rnd(beams, 8, tk_beam, 64),
          rnd(beams, 8, tk_beam, 64), padding_bias(toks), False), F32_TOL),
        ("q_decode_one", "B1 H8 Tq1 Tk512 D64 f32 one request",
         (rnd(1, 8, 1, 64), rnd(1, 8, MAX_LEN, 64), rnd(1, 8, MAX_LEN, 64),
          bias_one, False), F32_TOL),
        (MIXED_SHAPES[2], "B1 H8 Tq1 Tk512 D64 f32 q, bf16 K/V, one request",
         (rnd(1, 8, 1, 64), rnd(1, 8, MAX_LEN, 64, dtype=bf),
          rnd(1, 8, MAX_LEN, 64, dtype=bf), bias_one, False), F32_TOL),
        ("s_cross_decode", "B32 H8 Tq1 Tk128 D64 f32 padding bias (cross, "
         "model layout)", (heads_f32(beams, 1), heads_f32(beams, SRC_LEN),
                           heads_f32(beams, SRC_LEN), cross_bias, False),
         F32_TOL),
    ]
    return rows + translation + decodes


# #1's mixed entry (f32 q, bf16 K/V) is held by an f32 rule.  Kernel and
# plain version round the same normalised P to bf16 and sum P.V in f32, so
# an entry differs beyond F32_TOL only where the two f32 computations of
# one P (about 2e-7 apart) fall on the two sides of a bf16 rounding point:
# P moves by one bf16 ulp (2^-7 of it at most) and the row's D entries by
# that times v.  Reckoned at the decode shape, some 5e-5 of the P values
# do, and 0.4% of the entries move beyond F32_TOL.  So at most MIXED_SHARE
# of the entries may lie beyond F32_TOL of the plain version and, beside
# it, of an f64 anchor (the softmax in f64, P rounded to bf16 once, P.V in
# f64; at a split rounding one of the two rounds as the anchor does), and
# every entry lies within one bf16 ulp of each P it sums (2^-7 sum_j P_j
# |v_j|) of the plain version.  A P rounded before it is normalised (the
# one-sweep loop's rounding point) moves most entries by about 2e-3 of
# their size: chip_gate_controls.py shows this rule refusing it
MIXED_SHAPES = ("k_decode_mixed", "l_chunk_mixed", "r_decode_one_mixed")
MIXED_SHARE = 0.01


def mixed_anchor(q, k, v, bias):
    """(the f64 anchor of #1's mixed entry, the bound 2^-7 sum_j P_j
    |v_j| of each entry) for f32 q, bf16 k and v, as the rule above."""
    d = q.shape[-1]
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s, dim=-1)
    exact = torch.matmul(p.to(torch.bfloat16).double(), v.double())
    flip = torch.matmul(p, v.double().abs()) * 2.0 ** -7
    return exact, flip


def mixed_held(got, want, anchor):
    """(max abs err, entries beyond F32_TOL of both the plain version and
    the anchor, held) of #1's mixed entry by the rule above; ``anchor``
    is mixed_anchor's pair."""
    exact, flip = anchor
    g, w = got.double(), want.double()
    atol, rtol = F32_TOL["atol"], F32_TOL["rtol"]
    err = (g - w).abs()
    far = (err > atol + rtol * w.abs()) \
        & ((g - exact).abs() > atol + rtol * exact.abs())
    beyond = int(far.sum())
    ok = (beyond <= MIXED_SHARE * w.numel()
          and bool((err <= flip + atol).all()))
    return float(err.max()), beyond, ok


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
    shape) the device split.  The mixed rows (f32 q, bf16 K/V) are held by
    mixed_held; their yardstick is SDPA on K/V already upcast to f32, the
    upcast's copy timed apart, and beside them the scalar route on the
    same K/V upcast."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention_kernels as ak
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    with torch.no_grad():
        for key, desc, (q, k, v, bias, causal), tol in _inputs(gen):
            routes = dict(ak.flash_attention_fwd.routes)
            kernels = _read_kernels()
            out = ak.dot_product_attention(q, k, v, bias, causal=causal)
            ref = ak.plain_attention(q, k, v, bias, causal=causal)
            torch.cuda.synchronize()
            aligned = ak.rows_aligned(q, k, v)
            route = ak.fwd_route(q.dtype, aligned, k.dtype)
            kernel = ak.fwd_kernel(q.dtype, aligned, k.dtype, q.shape[2])
            routes[route] += 1
            kernels[kernel] += 1
            if ak.flash_attention_fwd.routes != routes \
                    or _read_kernels() != kernels:
                raise RuntimeError(f"{key}: the call took the routes "
                                   f"{ak.flash_attention_fwd.routes} and the "
                                   f"kernels {_read_kernels()}, not {routes}"
                                   f" and {kernels}")
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{key}: kernel output is not finite")
            seen = seen_rows(q.shape[2], k.shape[2], causal)
            mixed = route == "mixed_kv"
            if mixed:
                err, differ, ok = mixed_held(out, ref,
                                             mixed_anchor(q, k, v, bias))
            else:
                err, differ, ok = fwd_held(out, ref, seen)
            bias_err = (seen_bias(out, ref, seen)[0]
                        if q.dtype == torch.bfloat16 else None)
            if not ok:
                raise RuntimeError(f"{key}: kernel disagrees with the plain "
                                   f"version (max abs err {err:.3e}, error "
                                   f"bias {bias_err}, tolerance {tol}, bias "
                                   f"within {PARTIAL_BF16_BIAS:.3e}, "
                                   f"{differ} entries beyond it)")
            # the same mask: causal self-attention as is_causal (SDPA's
            # flash path), any other as an additive mask
            lib = (dict(is_causal=True) if bias is None and causal
                   and q.shape[2] == k.shape[2]
                   else dict(attn_mask=_sdpa_mask(q, k, bias, causal)))
            # SDPA takes one dtype: the mixed rows' K/V upcast beforehand
            k_lib, v_lib = (k.float(), v.float()) if mixed else (k, v)
            cfg = (q.shape[-1] ** -0.5, causal, k.shape[2] - q.shape[2])
            row = {
                "shape": key, "what": desc, "route": route,
                "kernel": kernel,
                "max_abs_err": err, "entries_differ": differ,
                "error_bias": bias_err,
                "ms": time_ms(lambda: ak.dot_product_attention(
                    q, k, v, bias, causal=causal), flush),
                "plain_ms": time_ms(lambda: ak.plain_attention(
                    q, k, v, bias, causal=causal), flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k_lib, v_lib, **lib), flush),
            }
            if mixed:
                row["upcast_ms"] = time_ms(lambda: (k.float(), v.float()),
                                           flush)
                row["f32_kv_ms"] = time_ms(lambda: ak._launch_fwd(
                    q, k_lib, v_lib, bias, *cfg, "scalar", kernel), flush)
            if kernel != "scalar_template":
                # the scalar template on the same inputs: the kernel this
                # one replaced, timed in the same run
                row["scalar_ms"] = time_ms(lambda: ak._launch_fwd(
                    q, k, v, bias, *cfg, route, "scalar_template"), flush)
            if key == "f_train":
                row["device_split_ms"] = device_split(
                    lambda: ak.dot_product_attention(q, k, v, bias,
                                                     causal=causal))
            row["bound_ms"], row["bound_by"] = bound(q, k, v, bias, causal,
                                                     rates)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            results.append(row)
            extra = "" if bias_err is None else f" bias {bias_err:+.3e}"
            scalar = ("" if "scalar_ms" not in row
                      else f"  scalar_ms {row['scalar_ms']:.5f}")
            if mixed:
                extra = f" ({differ} entries beyond F32_TOL)"
                scalar = (f"  scalar_ms {row['scalar_ms']:.5f}" if
                          "scalar_ms" in row else "")
                scalar += (f"  f32_kv_ms {row['f32_kv_ms']:.5f}  upcast_ms "
                           f"{row['upcast_ms']:.5f}")
            print(f"kernel {key:16s} {desc:48s} route {route:11s} kernel "
                  f"{kernel:15s} max_abs_err {err:.3e}{extra}  kernel_ms "
                  f"{row['ms']:.5f}{scalar}  plain_ms "
                  f"{row['plain_ms']:.5f}  library_ms "
                  f"{row['library_ms']:.5f}  bound_ms "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}, "
                  f"{row['share_of_bound']:.4f} of it)"
                  + _split_text(row))
    return results


ROW_EXTRA_KEYS = 200    # masked keys a row is extended by


def row_independence(gen):
    """#1's decode and tile kernels, f32 and mixed, give a row the same
    bits (out and lse) among others, alone, and over a Tk extended by
    ROW_EXTRA_KEYS keys its bias masks: a decode row among SLOTS slots,
    and a chunk row among 9 requests (9 x 8 heads x 4 blocks of rows: the
    tiles in one block on an H100) and alone (8 x 4 blocks: the tiles
    spread over blocks and merged).  Returns one reading a case; raises
    where a row differs."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    dev = "cuda"
    readings = []
    for kv in (torch.float32, torch.bfloat16):
        for what, b, tq in (("decode", SLOTS, 1),
                            ("chunk", 9, PREFILL_CHUNK)):
            def rnd(*shape, dtype=torch.float32):
                return torch.randn(*shape, generator=gen,
                                   device=dev).to(dtype)
            q = rnd(b, 8, tq, 64)
            k, v = rnd(b, 8, MAX_LEN, 64, dtype=kv), rnd(b, 8, MAX_LEN, 64,
                                                         dtype=kv)
            bias = torch.where(torch.rand(b, 1, tq, MAX_LEN, generator=gen,
                                          device=dev) > 0.85, -1e9, 0.0)
            scale = 64 ** -0.5
            i = b // 2
            k2, v2 = (torch.cat([t[i:i + 1], rnd(1, 8, ROW_EXTRA_KEYS, 64,
                                                 dtype=kv)], 2)
                      for t in (k, v))
            bias2 = torch.cat([bias[i:i + 1], torch.full(
                (1, 1, tq, ROW_EXTRA_KEYS), -1e9, device=dev)], -1)
            with torch.no_grad():
                many = ak.flash_attention_fwd(q, k, v, bias, scale=scale)
                alone = ak.flash_attention_fwd(q[i:i + 1], k[i:i + 1],
                                               v[i:i + 1], bias[i:i + 1],
                                               scale=scale)
                longer = ak.flash_attention_fwd(q[i:i + 1], k2, v2, bias2,
                                                scale=scale)
            torch.cuda.synchronize()
            rows = many[1].reshape(b, 8 * tq)[i].reshape(8, tq)
            same = {label: bool(torch.equal(got[0], many[0][i:i + 1])
                                and torch.equal(got[1], rows))
                    for label, got in (("alone", alone), ("longer", longer))}
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            kernel = "decode" if tq == 1 else "tile"
            # whether the row's parts went through the merge kernel (every
            # decode of more than one split; tiles spread over blocks) or
            # were folded in one block
            merged = {label: (-(-tk // ak.FWD_LAYOUT[0]) > 1
                              if kernel == "decode" else
                              ak.fwd_scratch(kernel, kv != torch.float32, bb,
                                             8, tq, tk, 64, sms)[0])
                      for label, bb, tk in (("many", b, MAX_LEN),
                                            ("alone", 1, MAX_LEN),
                                            ("longer", 1,
                                             MAX_LEN + ROW_EXTRA_KEYS))}
            r = {"case": f"{what} {'f32' if kv == torch.float32 else 'mixed'}",
                 "rows": b, "kernel": kernel, "parts_merged": merged,
                 "bit_for_bit": same}
            readings.append(r)
            print(f"row independence {r['case']}: row {i} of {b} alone "
                  f"{'equal' if same['alone'] else 'DIFFERS'}, over "
                  f"{ROW_EXTRA_KEYS} more masked keys "
                  f"{'equal' if same['longer'] else 'DIFFERS'} (parts "
                  f"merged across blocks: {merged})")
            if not all(same.values()):
                raise RuntimeError(f"row independence: {r['case']} row {i} "
                                   f"differs: {same}")
    return readings


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
    from bigdl_tpu_torch.serving import GenerationScheduler, ModelServer

    lm = serving_lm(device)

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
    kernels = _read_kernels()
    launches = counts["flash_attention_fwd"]
    stats = server.generation_stats()

    calls = stats["prefill_calls"] + stats["decode_steps"]
    q = np.quantile(np.asarray(ttft, dtype=float), [0.5, 0.99])
    print(f"serving: {stats['tokens_emitted']} new tokens in {wall:.4f} s = "
          f"{stats['tokens_emitted'] / wall:.2f} tokens/s; TTFT p50 "
          f"{q[0]:.5f} s, p99 {q[1]:.5f} s; prefill calls "
          f"{stats['prefill_calls']}, decode steps "
          f"{stats['decode_steps']}; flash_attention_fwd launches "
          f"{launches}, by kernel {kernels}")
    # one attention call per layer in every prefill call and decode step
    if launches == 0 or launches != LAYERS * calls:
        raise RuntimeError(f"kernel launches {launches} != layers x "
                           f"(prefill calls + decode steps) = "
                           f"{LAYERS * calls}")
    # the f32 serving path keeps #1's scalar template
    _check_routes(routes, "flash_attention_fwd",
                  {"tensor_core": 0, "scalar": launches}, "f32 serving")
    failed = kernels_held(kernels, LAYERS * stats["decode_steps"],
                          LAYERS * stats["prefill_calls"], "serving",
                          exact=False)
    if failed:
        raise RuntimeError("; ".join(failed))

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
    return counts, routes, kernels


# ---------------------------------------------------------------------------
# 5b. the prefix KV cache, dedup, the disaggregated engine, deadlines, kill
# ---------------------------------------------------------------------------

PREFIX_LEN, PREFIX_TAIL, PREFIX_NEW, PREFIX_G = 256, (8, 65), 16, 64
PREFIX_BUDGET = 2                  # prefill calls between decode steps
DEDUP_BURST, DEDUP_LEN = 8, PREFIX_LEN + 1     # region = 4 granules
DISAGG_REQUESTS, DISAGG_PREFILL_SLOTS = 16, 4


def serving_lm(device: str = "cuda"):
    """The serving phases' LM (random weights from seed 0)."""
    from bigdl_tpu_torch.models import TransformerLM
    return TransformerLM(vocab_size=VOCAB, hidden_size=HIDDEN,
                         num_layers=LAYERS, num_heads=HEADS,
                         filter_size=FILTER, max_len=MAX_LEN,
                         generator=torch.Generator().manual_seed(0),
                         device=device).eval()


def chunk_bytes(g: int = PREFIX_G) -> int:
    """One cached chunk as ``PrefixChunk`` counts it: K and V of every
    layer in f32, and one byte a pad flag."""
    return LAYERS * 2 * HEADS * g * (HIDDEN // HEADS) * 4 + g


def forced_margin(lm, row, tp: int, step: int) -> float:
    """Top-2 logit margin of a solo decode of new token ``step`` of
    ``row`` (``tp`` prompt tokens), fed the row's own tokens before it."""
    with torch.no_grad():
        p = lm._tokens(row[:tp + step])[None]
        caches = lm._prefill(p, lm.init_cache(1))
        logits, _ = lm.decode_step(p[:, -1:], tp + step - 1, caches)
        top2 = lm._mask_untrained_logit(logits)[0].topk(2).values
    return float(top2[0] - top2[1])


def rows_held(lm, prompts, got, want, what, failed):
    """Hold ``got`` against ``want`` row by row by the serving rule: equal,
    or first different at a new token whose top-2 margin, given the
    common history, is under NEAR_TIE.  Appends each breach to ``failed``;
    returns the near-tie margins."""
    margins = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a[:len(p)], p):
            failed.append(f"{what}: request {i} malformed {a.shape}")
            continue
        if np.array_equal(a, b):
            continue
        step = int(np.flatnonzero(a[len(p):] != b[len(p):])[0])
        margin = forced_margin(lm, a, len(p), step)
        margins.append(margin)
        print(f"prefix: {what}: request {i} differs at new token {step}; "
              f"top-2 logit margin {margin:.3e}", flush=True)
        if margin >= NEAR_TIE:
            failed.append(f"{what}: request {i} diverges at a margin of "
                          f"{margin:.3e} (not a near-tie)")
    return margins


def _prefix_prompts(rng, prefix, n, tail):
    return [np.concatenate([prefix, rng.integers(1, VOCAB + 1, int(t))
                            .astype(np.int32)])
            for t in rng.integers(tail[0], tail[1], n)]


def _serve_all(engine, prompts, max_new, start=False):
    futs = [engine.submit_async(p, max_new) for p in prompts]
    if start:
        engine.start()
    return [f.result(timeout=600) for f in futs]


def kv_round_trip(lm, device="cuda"):
    """A chunk extracted from a decoding slot, the slot then reused by
    another prompt, the chunk copied into a free slot: the copy must hold
    the K/V and pad flags the source slot held at the extract, bit for
    bit.  Returns (equal, the chunk's bytes)."""
    from bigdl_tpu_torch.serving import SlotPool
    rng = np.random.default_rng(21)
    pool = SlotPool(lm, slots=4, device=device)
    vocab = lm.embedding.weight.shape[0] - 1
    first, second = (rng.integers(1, vocab + 1, 200).astype(np.int32)
                     for _ in range(2))
    pool.prefill_into([first], [0], 256)
    for _ in range(4):
        pool.decode()
    want = [(c["self"]["k"][0, :, :2 * PREFIX_G].clone(),
             c["self"]["v"][0, :, :2 * PREFIX_G].clone())
            for c in pool.caches["layers"]]
    want_pad = pool.caches["pad"][0, :2 * PREFIX_G].clone()
    layers, pad = pool.kv_extract(0, 0, 2 * PREFIX_G)
    pool.release(0)
    pool.prefill_into([second], [0], 256)
    pool.decode()
    pool.kv_copy_into(2, layers, pad, 0)
    got = pool.caches
    equal = bool(torch.equal(got["pad"][2, :2 * PREFIX_G], want_pad)) and all(
        torch.equal(c["self"]["k"][2, :, :2 * PREFIX_G], k)
        and torch.equal(c["self"]["v"][2, :, :2 * PREFIX_G], v)
        for (k, v), c in zip(want, got["layers"]))
    size = sum(t.numel() * t.element_size()
               for lay in layers for t in lay.values()) + pad.numel()
    return equal, size


def _deadline_and_kill(lm, failed, device="cuda"):
    """A paced request under Deadline(0.25) fails typed and its slot
    serves the next; kill() fails residents dead and queued closed."""
    import threading
    from bigdl_tpu_torch.serving import (Deadline, DeadlineExceededError,
                                         ModelServer, ReplicaDeadError,
                                         ServerClosedError)
    out = {}
    prompt = np.array([2, 4, 6, 8], np.int32)
    server = ModelServer(generator=lm, slots=1, device=device)
    try:
        started = threading.Event()

        def slow(_tok):
            started.set()
            time.sleep(0.05)
        fut = server.submit_generate_async(prompt, 50, on_token=slow,
                                           deadline=Deadline(0.25))
        started.wait(60)
        try:
            fut.result(60)
            failed.append("deadline: a 0.25 s budget was never enforced")
        except DeadlineExceededError as e:
            out["deadline_stage"] = e.stage
            if e.stage not in ("prefill", "decode"):
                failed.append(f"deadline: stage {e.stage!r}")
        t0 = time.perf_counter()
        row = server.submit_generate(prompt, 6, timeout=60)
        out["next_request_s"] = time.perf_counter() - t0
        rows_held(lm, [prompt], [row], [lm.generate(prompt[None], 6)[0]
                                        .cpu().numpy()],
                  "deadline: the freed slot's next request", failed)
    finally:
        server.shutdown(drain=False, timeout=30)

    server = ModelServer(generator=lm, slots=2, device=device)
    engine = server.generation
    started = [threading.Event(), threading.Event()]

    def pace(i):
        def on_token(_tok):
            started[i].set()
            time.sleep(0.02)
        return on_token
    residents = [server.submit_generate_async(
        np.array([3 + i, 5, 7], np.int32), 40, on_token=pace(i))
        for i in range(2)]
    queued = [server.submit_generate_async(np.array([4, 4], np.int32), 4)
              for _ in range(3)]
    if not all(e.wait(60) for e in started):
        failed.append("kill: the residents never streamed")
    server.kill()
    out["kill"] = []
    for f, want in ([(f, ReplicaDeadError) for f in residents]
                    + [(f, ServerClosedError) for f in queued]):
        exc = f.exception(60)
        out["kill"].append(type(exc).__name__)
        if not isinstance(exc, want):
            failed.append(f"kill: {type(exc).__name__}, not "
                          f"{want.__name__}")
    engine._thread.join(60)
    if engine.alive or engine._pending is not None:
        failed.append("kill: the engine thread is alive or left a step "
                      "unread")
    out["threads_left"] = sum(t is engine._thread
                              for t in threading.enumerate())
    server.shutdown()
    return out


def prefix_reading(device: str = "cuda"):
    """The serving LM through the prefix KV cache (cache on and off), an
    eviction run, a dedup burst, the disaggregated engine against a single
    engine, a KV round trip through a reused slot, a deadline and a kill.
    Returns the readings and the list of failed checks."""
    from bigdl_tpu_torch.serving import (DisaggregatedEngine,
                                         GenerationScheduler,
                                         run_shared_prefix_workload)
    lm = serving_lm(device)
    failed = []
    r = {}
    cfg = dict(slots=SLOTS, prefill_chunk=PREFILL_CHUNK,
               prefix_granularity=PREFIX_G, device=device)

    # shared prefix, cache on then off
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    shared = run_shared_prefix_workload(
        lm, n_requests=N_REQUESTS, prefix_len=PREFIX_LEN, tail=PREFIX_TAIL,
        max_new=PREFIX_NEW, prefill_chunk_budget=PREFIX_BUDGET,
        oracle_sample=0, **cfg)
    torch.cuda.synchronize()
    r["shared"] = {k: shared[k] for k in ("cache", "nocache",
                                          "shared_fraction",
                                          "ttft_p50_speedup")}
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    r["launches"] = _read_counts()
    r["routes"] = _read_routes()
    r["kernels"] = _read_kernels()
    calls = sum(shared[run]["engine_totals"]["prefill_calls"]
                + shared[run]["engine_totals"]["decode_steps"]
                for run in ("cache", "nocache"))
    steps = sum(shared[run]["engine_totals"]["decode_steps"]
                for run in ("cache", "nocache"))
    failed += kernels_held(r["kernels"], LAYERS * steps,
                           LAYERS * (calls - steps), "shared prefix",
                           exact=False)
    got = r["launches"]["flash_attention_fwd"]
    if got == 0 or got != LAYERS * calls:
        failed.append(f"shared prefix: #1 launched {got} times, not layers "
                      f"x (prefill and chunk calls + decode steps) = "
                      f"{LAYERS * calls}")
    if not routes_are(r["routes"]["flash_attention_fwd"],
                      {"scalar": got}):
        failed.append(f"shared prefix: #1 took the routes "
                      f"{r['routes']['flash_attention_fwd']}, not scalar")
    on, off = shared["cache"], shared["nocache"]
    if not on["prefix_cache"]["hits"] > 0:
        failed.append("shared prefix: no cache hit with the cache on")
    if off["prefix_cache"] is not None or off["prefix_chunks_copied"]:
        failed.append("shared prefix: chunks copied with the cache off")
    prompts = shared["prompts"]
    r["shared_margins"] = rows_held(
        lm, prompts, shared["rows"]["cache"], shared["rows"]["nocache"],
        "shared prefix: cache on vs off", failed)
    solo = [lm.generate(p[None], PREFIX_NEW)[0].cpu().numpy()
            for p in prompts[:2]]
    r["solo_margins"] = rows_held(lm, prompts[:2],
                                  shared["rows"]["cache"][:2], solo,
                                  "shared prefix: cache on vs solo", failed)

    # eviction: a budget of three chunks, two alternating prefixes
    rng = np.random.default_rng(31)
    heads = [rng.integers(1, VOCAB + 1, PREFIX_LEN).astype(np.int32)
             for _ in range(2)]
    engine = GenerationScheduler(lm, prefix_cache_bytes=3 * chunk_bytes(),
                                 **cfg)
    evict_prompts, evict_rows = [], []
    try:
        for _round in range(3):
            batch = [_prefix_prompts(rng, h, 1, (8, 17))[0] for h in heads]
            evict_prompts += batch
            evict_rows += _serve_all(engine, batch, PREFIX_NEW)
        r["eviction"] = engine.stats()["prefix_cache"]
    finally:
        engine.shutdown()
    if not r["eviction"]["evictions"] > 0:
        failed.append("eviction: nothing was evicted")
    if r["eviction"]["resident_bytes"] > r["eviction"]["byte_budget"]:
        failed.append("eviction: the cache outgrew its budget")
    r["eviction_margins"] = rows_held(
        lm, evict_prompts, evict_rows,
        [lm.generate(p[None], PREFIX_NEW)[0].cpu().numpy()
         for p in evict_prompts], "eviction vs solo", failed)

    # dedup: a burst of identical cold prompts, then one cold prompt alone
    burst = rng.integers(1, VOCAB + 1, DEDUP_LEN).astype(np.int32)
    lone = rng.integers(1, VOCAB + 1, DEDUP_LEN).astype(np.int32)
    engine = GenerationScheduler(lm, prefix_cache_bytes=1 << 28,
                                 start=False, **cfg)
    try:
        burst_rows = _serve_all(engine, [burst] * DEDUP_BURST, PREFIX_NEW,
                                start=True)
        st = engine.stats()
        _serve_all(engine, [lone], PREFIX_NEW)
        lone_calls = engine.stats()["prefill_calls"] - st["prefill_calls"]
    finally:
        engine.shutdown()
    r["dedup"] = {k: st[k] for k in ("prefill_dedup_leaders",
                                     "prefill_dedup_followers",
                                     "prefill_calls",
                                     "prefix_chunks_copied")}
    r["dedup"]["lone_prefill_calls"] = lone_calls
    if (st["prefill_dedup_leaders"], st["prefill_dedup_followers"]) != \
            (1, DEDUP_BURST - 1):
        failed.append(f"dedup: {st['prefill_dedup_leaders']} leaders and "
                      f"{st['prefill_dedup_followers']} followers, not 1 "
                      f"and {DEDUP_BURST - 1}")
    if st["prefill_calls"] != lone_calls:
        failed.append(f"dedup: the burst ran {st['prefill_calls']} prefill "
                      f"calls, one prompt {lone_calls}")
    want = lm.generate(burst[None], PREFIX_NEW)[0].cpu().numpy()
    rows_held(lm, [burst] * DEDUP_BURST, burst_rows,
              [want] * DEDUP_BURST, "dedup vs solo", failed)

    # disaggregated prefill -> decode against one engine
    lens = rng.integers(16, 400, DISAGG_REQUESTS)
    dis_prompts = [rng.integers(1, VOCAB + 1, int(n)).astype(np.int32)
                   for n in lens]
    through_prefill = sum(int(n) - 1 >= PREFIX_G for n in lens)
    torch.cuda.synchronize()
    _zero_counts()
    de = DisaggregatedEngine(lm, decode_slots=SLOTS,
                             prefill_slots=DISAGG_PREFILL_SLOTS,
                             prefix_cache_bytes=1 << 28,
                             prefix_granularity=PREFIX_G,
                             prefill_chunk=PREFILL_CHUNK, device=device)
    try:
        futs = [de.submit_generate_async(p, PREFIX_NEW)
                for p in dis_prompts]
        dis_rows = [f.result(timeout=600) for f in futs]
    finally:
        de.shutdown()
    dst = de.stats()        # after the drain, which reads the last step
    torch.cuda.synchronize()
    r["disagg_launches"] = _read_counts()
    r["disagg_routes"] = _read_routes()
    r["disagg_kernels"] = _read_kernels()
    r["disaggregated"] = {
        "handoffs": dst["handoffs"],
        "through_prefill_tier": dst["prefill_engine"]["requests_done"],
        "retries": dst["prefill_engine_retries"],
        "decode_prefill_calls": dst["prefill_calls"],
        "prefill_engine_calls": dst["prefill_engine"]["prefill_calls"],
        "chunks_copied": dst["prefix_chunks_copied"],
        "decode_steps": dst["decode_steps"]}
    if dst["prefill_engine"]["requests_done"] != through_prefill \
            or dst["handoffs"] != DISAGG_REQUESTS:
        failed.append(f"disaggregated: {dst['prefill_engine']['requests_done']}"
                      f" requests through the prefill tier (want "
                      f"{through_prefill}, those whose region reaches "
                      f"{PREFIX_G}), {dst['handoffs']} handed to decode")
    calls = (dst["prefill_engine"]["prefill_calls"] + dst["prefill_calls"]
             + dst["decode_steps"])
    got = r["disagg_launches"]["flash_attention_fwd"]
    if got == 0 or got != LAYERS * calls:
        failed.append(f"disaggregated: #1 launched {got} times, not "
                      f"{LAYERS * calls}")
    if r["disagg_routes"]["flash_attention_fwd"]["tensor_core"]:
        failed.append("disaggregated: #1 took the tensor-core route")
    failed += kernels_held(r["disagg_kernels"], LAYERS * dst["decode_steps"],
                           LAYERS * (calls - dst["decode_steps"]),
                           "disaggregated", exact=False)
    engine = GenerationScheduler(lm, prefix_cache_bytes=1 << 28, **cfg)
    try:
        single_rows = _serve_all(engine, dis_prompts, PREFIX_NEW)
    finally:
        engine.shutdown()
    r["disagg_margins"] = rows_held(lm, dis_prompts, dis_rows, single_rows,
                                    "disaggregated vs single engine",
                                    failed)

    # the copy itself, bit for bit, through a reused slot
    equal, size = kv_round_trip(lm, device)
    r["round_trip"] = {"bit_for_bit": equal, "bytes": size}
    if not equal:
        failed.append("round trip: a chunk extracted from a decoding slot "
                      "and copied into a free slot after the slot's reuse "
                      "differs from the slot's K/V at the extract")

    r["reliability"] = _deadline_and_kill(lm, failed, device)
    r["failed"] = failed
    return r


def phase_prefix(smi, device: str = "cuda"):
    """5b: the prefix KV cache on the serving LM; see prefix_reading."""
    def report(r):
        for label in ("cache", "nocache"):
            run = r["shared"][label]
            cache = run["prefix_cache"] or {}
            print(f"prefix: shared prefix {PREFIX_LEN} + tails "
                  f"{PREFIX_TAIL[0]}-{PREFIX_TAIL[1] - 1}, {N_REQUESTS} "
                  f"requests, cache {'on' if label == 'cache' else 'off'}: "
                  f"TTFT p50 {run['queue_to_first_token_s_p50']:.5f} s, p99 "
                  f"{run['queue_to_first_token_s_p99']:.5f} s; "
                  f"{run['tokens_per_sec']:.2f} tokens/s; prefill calls "
                  f"{run['prefill_calls']} in {run['prefill_seconds']:.5f} "
                  f"s; chunks copied {run['prefix_chunks_copied']}; hit rate "
                  f"{cache.get('hit_rate', 0.0):.4f}", flush=True)
        print(f"prefix: TTFT p50 speedup {r['shared']['ttft_p50_speedup']:.3f}"
              f"; peak memory {r['peak_memory_bytes']} bytes; #1 launches "
              f"{r['launches']['flash_attention_fwd']} "
              f"{r['routes']['flash_attention_fwd']} {r['kernels']}; "
              f"near-tie rows "
              f"{len(r['shared_margins'])} (cache on vs off), "
              f"{len(r['solo_margins'])} (vs solo); on {smi}")
        ev = r["eviction"]
        print(f"prefix: eviction: budget {ev['byte_budget']} bytes "
              f"(3 chunks of {chunk_bytes()}), inserts {ev['inserts']}, "
              f"evictions {ev['evictions']}, hits {ev['hits']}, resident "
              f"{ev['resident_bytes']}")
        print(f"prefix: dedup burst of {DEDUP_BURST}: {r['dedup']}")
        print(f"prefix: disaggregated {DISAGG_REQUESTS} requests: "
              f"{r['disaggregated']}; #1 launches "
              f"{r['disagg_launches']['flash_attention_fwd']} "
              f"{r['disagg_kernels']}")
        print(f"prefix: round trip {r['round_trip']}; deadline and kill "
              f"{r['reliability']}")
    return _phase("prefix", lambda: prefix_reading(device), report)


# ---------------------------------------------------------------------------
# 5c. one-shot serving: the LM behind the dynamic batcher; ResNet-50 behind
# the Predictor, the Evaluator and the PredictionService
# ---------------------------------------------------------------------------

ONESHOT_BATCH, ONESHOT_TIMEOUT_MS, ONESHOT_LEN = 16, 5.0, 128
ONESHOT_THREADS, ONESHOT_EACH, ONESHOT_LONE = 8, 8, 3
ONESHOT_REQUESTS = ONESHOT_THREADS * ONESHOT_EACH + ONESHOT_BATCH \
    + ONESHOT_LONE                                     # 83
ONESHOT_TIMED = 5                  # timed runs of a full bucket (median)
RESNET_ONESHOT_BATCH, RESNET_ONESHOT_IMAGES = 32, 40
RESNET_ONESHOT_CLASSES, RESNET_ONESHOT_SIZE = 1000, 224
# ResNet-50's f32 eval logits on the card (cuDNN) against its CPU copy
RESNET_ONESHOT_REL = 1e-4          # of max |logit|


def oneshot_rows_held(lm, rows, replies, what, failed):
    """Hold each one-shot reply against ``lm``'s forward of its row alone
    on the same device: within F32_TOL, and the same argmax at every
    position bar a near-tie (the solo logits' top-2 margin under
    NEAR_TIE; ``torch.matmul``'s kernels may vary with the row count).
    Appends each breach to ``failed``; returns (max abs error, positions
    whose argmax differs at a near-tie)."""
    worst, ties = 0.0, 0
    with torch.inference_mode():
        for i, (row, reply) in enumerate(zip(rows, replies)):
            want = lm(row[None])[0]
            got = torch.as_tensor(reply).to(want.device)
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                failed.append(f"{what}: request {i} malformed "
                              f"{tuple(got.shape)}, not {tuple(want.shape)}")
                continue
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.allclose(got, want, **F32_TOL):
                failed.append(f"{what}: request {i} differs from its solo "
                              f"forward by {err:.3e}")
            differ = got.argmax(-1) != want.argmax(-1)
            if bool(differ.any()):
                top2 = want[differ].topk(2, dim=-1).values
                margin = float((top2[:, 0] - top2[:, 1]).max())
                ties += int(differ.sum())
                if margin >= NEAR_TIE:
                    failed.append(f"{what}: request {i}'s argmax differs "
                                  f"at a margin of {margin:.3e} (not a "
                                  f"near-tie)")
    return worst, ties


def oneshot_lm_reading(device: str = "cuda", lm=None,
                       length: int = ONESHOT_LEN) -> dict:
    """The serving LM one-shot: ``ModelServer(backend=lm, max_batch=16,
    batch_timeout_ms=5)`` after ``warmup`` on a ``length``-token row; 64
    requests from 8 threads released together (each waits for its reply
    before the next), a burst of 16 through ``submit_many``, 3 lone
    requests.  Counts are set to 0 before the warmup and read after
    ``shutdown()``.  Returns the readings and the failed checks."""
    from bigdl_tpu_torch.optim.predictor import jit_forward
    from bigdl_tpu_torch.serving import ModelServer
    lm = serving_lm(device) if lm is None else lm
    layers = len(lm.blocks)
    vocab = lm.embedding.weight.shape[0] - 1
    rng = np.random.default_rng(41)
    clients = [[rng.integers(1, vocab + 1, length).astype(np.int32)
                for _ in range(ONESHOT_EACH)]
               for _ in range(ONESHOT_THREADS)]
    burst = [rng.integers(1, vocab + 1, length).astype(np.int32)
             for _ in range(ONESHOT_BATCH)]
    lone = [rng.integers(1, vocab + 1, length).astype(np.int32)
            for _ in range(ONESHOT_LONE)]
    failed, r, errors = [], {}, []
    replies = [[None] * ONESHOT_EACH for _ in range(ONESHOT_THREADS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = ModelServer(lm, max_batch=ONESHOT_BATCH,
                         batch_timeout_ms=ONESHOT_TIMEOUT_MS, device=device)
    gate = threading.Barrier(ONESHOT_THREADS)

    def client(t):
        try:
            gate.wait()
            for j, x in enumerate(clients[t]):
                replies[t][j] = server.submit(x, timeout=600)
        except Exception as e:  # noqa: BLE001 - a failed client fails
            errors.append(f"{type(e).__name__}: {e}")

    _zero_counts()
    try:
        t0 = time.perf_counter()
        server.warmup(burst[0])
        r["warmup_s"] = time.perf_counter() - t0
        workers = [threading.Thread(target=client, args=(t,))
                   for t in range(ONESHOT_THREADS)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        r["concurrent_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        burst_replies = server.submit_many(burst, timeout=600)
        r["burst_s"] = time.perf_counter() - t0
        lone_replies, r["lone_s"] = [], []
        for x in lone:
            t0 = time.perf_counter()
            lone_replies.append(server.submit(x, timeout=600))
            r["lone_s"].append(time.perf_counter() - t0)
    finally:
        server.shutdown()
    torch.cuda.synchronize()
    r["launches"], r["routes"] = _read_counts(), _read_routes()
    r["kernels"] = _read_kernels()
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    failed += [f"client: {e}" for e in errors]
    snap = r["metrics"] = server.metrics.snapshot()
    occ = snap["occupancy"]
    if snap["requests"] != ONESHOT_REQUESTS or \
            sum(n * c for n, c in occ.items()) != ONESHOT_REQUESTS:
        failed.append(f"metrics: {snap['requests']} requests counted, "
                      f"{sum(n * c for n, c in occ.items())} in the "
                      f"occupancy, not {ONESHOT_REQUESTS}")
    if sum(occ.values()) != snap["batches"]:
        failed.append(f"metrics: the occupancy histogram holds "
                      f"{sum(occ.values())} batches, not {snap['batches']}")
    got = r["launches"]["flash_attention_fwd"]
    want = layers * (snap["batches"] + len(server.buckets))
    if got == 0 or got != want:
        failed.append(f"#1 launched {got} times, not layers x (batches + "
                      f"warm-up buckets) = {want}")
    if not routes_are(r["routes"]["flash_attention_fwd"],
                      {"scalar": got}):
        failed.append(f"#1 took the routes {r['routes']['flash_attention_fwd']}"
                      f", not scalar")
    failed += kernels_held(r["kernels"], 0, want, "oneshot_lm")
    rows = [x for c in clients for x in c] + burst + lone
    got_rows = [y for c in replies for y in c] + burst_replies + lone_replies
    if any(y is None for y in got_rows):
        failed.append("a client's request went unanswered")
    else:
        r["max_abs_err"], r["near_tie_positions"] = oneshot_rows_held(
            lm, rows, got_rows, "oneshot_lm", failed)
    # one full bucket, on the device and read back, outside the counts
    model, fn = jit_forward(lm, device)
    x = np.stack(burst)
    device_ms, readback_ms = [], []
    for _ in range(ONESHOT_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(model, x)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        host = y.cpu().numpy()
        readback_ms.append((time.perf_counter() - t0) * 1e3)
    r["bucket"] = {"rows": ONESHOT_BATCH, "tokens": length,
                   "logit_bytes": host.nbytes,
                   "device_ms": float(np.median(device_ms)),
                   "readback_ms": float(np.median(readback_ms))}
    del model, y, host
    r["failed"] = failed
    return r


def oneshot_resnet_model(device: str = "cuda",
                         classes: int = RESNET_ONESHOT_CLASSES):
    """resnet50(classes) in eval mode, f32, with every BatchNorm's scale
    drawn from U(0.5, 1.5) and running statistics from a seed (so that
    every block and statistic counts; fresh ones give logits of about
    0.02, equal across rows), and its CPU copy."""
    import copy
    from bigdl_tpu_torch.models import resnet50
    model = resnet50(classes, generator=torch.Generator().manual_seed(2),
                     device=device).eval()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if "bn" in name and name.endswith(".weight"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return model, copy.deepcopy(model).to("cpu")


def _logits_held(got, want, what, failed):
    err = float(np.abs(np.asarray(got) - want).max())
    scale = float(np.abs(want).max())
    if not np.isfinite(got).all() or err > RESNET_ONESHOT_REL * scale:
        failed.append(f"{what}: logits off the CPU copy's by {err:.3e} "
                      f"(max |logit| {scale:.3e})")
    return err / scale


def oneshot_resnet_reading(device: str = "cuda",
                           size: int = RESNET_ONESHOT_SIZE,
                           classes: int = RESNET_ONESHOT_CLASSES) -> dict:
    """ResNet-50 one-shot: ``Predictor(batch_size=32)`` over the entry's
    ones batch (8 x 224 x 224 x 3) and 40 random images (32, then 8
    padded to 32), ``predict_class``, ``Evaluator`` (Top1, Top5, Loss),
    a ``PredictionService`` from 4 threads x 4 requests with one
    ``predict_bytes`` round trip, and ``serve()`` in front of it; every
    output against a CPU copy.  Returns the readings and the failed
    checks."""
    import io
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import (Evaluator, Loss, PredictionService,
                                       Predictor, Top1Accuracy,
                                       Top5Accuracy)
    model, cpu = oneshot_resnet_model(device, classes)
    rng = np.random.default_rng(43)
    ones = np.ones((8, size, size, 3), np.float32)
    imgs = rng.normal(size=(RESNET_ONESHOT_IMAGES, size, size, 3)) \
        .astype(np.float32)
    labels = rng.integers(1, classes + 1, RESNET_ONESHOT_IMAGES)
    with torch.inference_mode():
        want_ones = cpu(torch.from_numpy(ones)).numpy()
        want = np.concatenate([cpu(torch.from_numpy(imgs[i:i + 8])).numpy()
                               for i in range(0, len(imgs), 8)])
    failed, r = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    predictor = Predictor(model, batch_size=RESNET_ONESHOT_BATCH,
                          device=device)
    r["entry_rel_err"] = _logits_held(
        np.stack(predictor.predict(list(ones))), want_ones,
        "Predictor at the entry's ones", failed)
    r["rel_err"] = _logits_held(np.stack(predictor.predict(list(imgs))),
                                want, "Predictor at 40 images", failed)
    got_classes = predictor.predict_class(list(imgs))
    top2 = np.sort(want, axis=1)[:, -2:]
    wrong = (got_classes != want.argmax(axis=1) + 1) & \
        (top2[:, 1] - top2[:, 0] >= NEAR_TIE)
    if wrong.any():
        failed.append(f"predict_class differs from the CPU copy's argmax + 1 "
                      f"at {np.flatnonzero(wrong).tolist()}")
    results = Evaluator(model, batch_size=RESNET_ONESHOT_BATCH,
                        device=device).evaluate(
        [Sample(x, int(y)) for x, y in zip(imgs, labels)],
        [Top1Accuracy(), Top5Accuracy(), Loss()])
    r["evaluation"] = {m.fmt: res.result() for res, m in results}
    top1 = float(np.mean(want.argmax(axis=1) + 1 == labels))
    if any(n != RESNET_ONESHOT_IMAGES for _, n in r["evaluation"].values()):
        failed.append(f"Evaluator counted {r['evaluation']}, not "
                      f"{RESNET_ONESHOT_IMAGES} samples")
    if abs(r["evaluation"]["Top1Accuracy"][0] - top1) > 1e-9:
        failed.append(f"Evaluator's Top1 {r['evaluation']['Top1Accuracy']} "
                      f"against the CPU copy's {top1}")
    svc = PredictionService(model, concurrency=4, device=device)
    outs, errors = {}, []

    def client(t):
        try:
            for j in range(4):
                lo = (4 * t + j) * 2 % len(imgs)
                outs[lo] = svc.predict(imgs[lo:lo + 2])
        except Exception as e:  # noqa: BLE001 - a failed client fails
            errors.append(f"{type(e).__name__}: {e}")
    workers = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    failed += [f"PredictionService client: {e}" for e in errors]
    for lo, y in outs.items():
        _logits_held(y, want[lo:lo + 2], f"PredictionService at {lo}",
                     failed)
    buf = io.BytesIO()
    np.save(buf, imgs[:2], allow_pickle=False)
    _logits_held(np.load(io.BytesIO(svc.predict_bytes(buf.getvalue()))),
                 want[:2], "predict_bytes", failed)
    server = svc.serve(max_batch=8, batch_timeout_ms=5.0)
    try:
        served = server.submit_many(list(imgs[:8]), timeout=600)
    finally:
        server.shutdown()
    _logits_held(np.stack(served), want[:8], "serve()", failed)
    torch.cuda.synchronize()
    r["launches"] = _read_counts()
    if any(r["launches"].values()):
        failed.append(f"a kernel launched on the eval path: {r['launches']}")
    # images/s at batch 32 (host arrays in, logits back on the host)
    batch = list(imgs[:RESNET_ONESHOT_BATCH])
    times = []
    for _ in range(ONESHOT_TIMED):
        t0 = time.perf_counter()
        predictor.predict(batch)
        times.append(time.perf_counter() - t0)
    r["images_per_s"] = RESNET_ONESHOT_BATCH / float(np.median(times))
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    r["failed"] = failed
    return r


def oneshot_reading(device: str = "cuda") -> dict:
    lm = oneshot_lm_reading(device)
    resnet = oneshot_resnet_reading(device)
    return {"lm": lm, "resnet": resnet,
            "failed": [f"oneshot_lm: {f}" for f in lm["failed"]]
            + [f"oneshot_resnet: {f}" for f in resnet["failed"]]}


def phase_oneshot(smi, device: str = "cuda"):
    """5c: one-shot serving of the LM and ResNet-50; see
    oneshot_lm_reading and oneshot_resnet_reading."""
    def report(r):
        lm, snap = r["lm"], r["lm"]["metrics"]
        lat = snap["latency_ms"]
        conc = ONESHOT_THREADS * ONESHOT_EACH
        print(f"oneshot: LM L{LAYERS} H{HIDDEN} vocab {VOCAB}, rows of "
              f"{ONESHOT_LEN} tokens, max_batch {ONESHOT_BATCH}, timeout "
              f"{ONESHOT_TIMEOUT_MS} ms: warmup {lm['warmup_s']:.4f} s; "
              f"{conc} requests from {ONESHOT_THREADS} threads in "
              f"{lm['concurrent_s']:.4f} s = "
              f"{conc / lm['concurrent_s']:.2f} requests/s; burst of "
              f"{ONESHOT_BATCH} in {lm['burst_s']:.4f} s; lone requests "
              f"{[round(s, 5) for s in lm['lone_s']]} s; latency p50 "
              f"{lat['p50']:.3f} ms, p90 {lat['p90']:.3f}, p99 "
              f"{lat['p99']:.3f} (host clock); {snap['requests']} requests "
              f"in {snap['batches']} batches, occupancy "
              f"{dict(sorted(snap['occupancy'].items()))}, padded waste "
              f"{snap['padded_waste']:.4f}; #1 launches "
              f"{lm['launches']['flash_attention_fwd']} "
              f"{lm['routes']['flash_attention_fwd']} {lm['kernels']}; "
              f"rows within "
              f"{lm.get('max_abs_err', float('nan')):.3e} of their solo "
              f"forward, {lm.get('near_tie_positions', 0)} near-tie "
              f"positions; peak memory {lm['peak_memory_bytes']} bytes; "
              f"on {smi}", flush=True)
        b = lm["bucket"]
        print(f"oneshot: a full bucket ({b['rows']} x {b['tokens']} "
              f"tokens): device {b['device_ms']:.4f} ms (CUDA events), "
              f"readback of {b['logit_bytes']} bytes of logits "
              f"{b['readback_ms']:.4f} ms (host clock); on {smi}",
              flush=True)
        rn = r["resnet"]
        print(f"oneshot: ResNet-50 eval f32: Predictor(batch_size="
              f"{RESNET_ONESHOT_BATCH}) {rn['images_per_s']:.2f} images/s; "
              f"logits within {rn['entry_rel_err']:.3e} (the entry's ones) "
              f"and {rn['rel_err']:.3e} (40 images) of max |logit| of the "
              f"CPU copy; Evaluator {rn['evaluation']}; launches "
              f"{sum(rn['launches'].values())}; peak memory "
              f"{rn['peak_memory_bytes']} bytes; on {smi}", flush=True)
    return _phase("oneshot", lambda: oneshot_reading(device), report)


# ---------------------------------------------------------------------------
# 5d. beam search on the serving LM and on the encoder-decoder Transformer;
# a bf16 KV cache served under the f32 LM
# ---------------------------------------------------------------------------

BEAM_ROWS, BEAM_SIZE, BEAM_NEW, BEAM_ALPHA = 8, 4, 32, 0.6
BEAM_PROMPT, BEAM_TP = (16, 129), 128   # prompts left-padded to 128 tokens
BEAM_TIMED = 3                         # timed searches (median)
# Transformer-base (Vaswani et al. 2017): H512, 8 heads, filter 2048, 6
# encoder and 6 decoder layers; the serving LM's vocab
TRANSLATION_FILTER, TRANSLATION_LAYERS = 2048, 6
SRC_LEN, TGT_MAX, TGT_CHECK, TEACHER_TT = 128, 64, 32, 64
TEACHER_TIMED = 5


def translation_model(device: str = "cuda"):
    """The translation phase's Transformer (random weights from seed 0)."""
    from bigdl_tpu_torch.nn import Transformer
    return Transformer(VOCAB, HIDDEN, HEADS, TRANSLATION_FILTER,
                       TRANSLATION_LAYERS, with_share_weights_linear=True,
                       transformer_type="translation",
                       generator=torch.Generator().manual_seed(0),
                       device=device).eval()


@contextmanager
def recorded_decisions():
    """Record every top-k decision of the beam searches run inside, on the
    host: (the k + 1 largest values, their indices; the first k taken) a
    call, three calls a step (the candidates, the alive beams, the
    finished pool)."""
    from bigdl_tpu_torch.nn import attention
    top_k, calls = attention._top_k, []

    def recording(x, k):
        values, index = top_k(x, k + 1)
        calls.append((values.cpu().numpy(), index.cpu().numpy()))
        return values[..., :k], index[..., :k]
    attention._top_k = recording
    try:
        yield calls
    finally:
        attention._top_k = top_k


def _decision_margin(values, index, took) -> float:
    """The margin at which a decision parted from the CPU's: at the first
    place j where the k indices ``took`` differ from the CPU's ``index``
    (its k + 1 largest, with their ``values``), the CPU's value there
    less the CPU's value of the index taken instead.  inf where that index
    is not among the CPU's k + 1, or either value is masked (-1e9, below
    -5e8: the order of masked values is the stable sort's, which no
    rounding moves)."""
    j = int(np.flatnonzero(took != index[:len(took)])[0])
    other = np.flatnonzero(index == took[j])
    if other.size == 0 or min(values[j], values[other[0]]) < -5e8:
        return float("inf")
    return float(values[j] - values[other[0]])


def beams_held(got, want, got_calls, want_calls, what, failed,
               logit_peak=0.0):
    """Hold a beam search on the card (``got``: sequences, scores) against
    the same search on the CPU (``want``) row by row, by rows_held's rule
    applied to the search's decisions: every top-k decision the same and
    then the sequences equal and the scores within F32_TOL of the logits
    they are summed from, or the first different decision taken at a
    near-tie (where the two decisions part, the CPU's value of its own
    pick and of the card's differ by less than NEAR_TIE).  A score sums log-probs, each the difference of a logit
    and the log-sum-exp, values of the logits' size (``logit_peak``, the
    largest |logit| of the search, logit_peaks), so their f32 rounding
    scales with that size and not with the score's: a near-deterministic
    step has a log-prob near 0 computed from logits near 20.  So a score
    holds within atol + rtol x logit_peak.  Returns the near-tie
    margins."""
    seq_g, sc_g = (np.asarray(t.cpu()) for t in got)
    seq_w, sc_w = (np.asarray(t.cpu()) for t in want)
    if seq_g.shape != seq_w.shape or sc_g.shape != sc_w.shape:
        failed.append(f"{what}: shapes {seq_g.shape} {sc_g.shape}, not "
                      f"{seq_w.shape} {sc_w.shape}")
        return []
    margins = []
    score_tol = F32_TOL["atol"] + F32_TOL["rtol"] * logit_peak
    for b in range(seq_w.shape[0]):
        first = next((c for c in range(max(len(got_calls), len(want_calls)))
                      if c >= min(len(got_calls), len(want_calls))
                      or not np.array_equal(got_calls[c][1][b][:-1],
                                            want_calls[c][1][b][:-1])),
                     None)
        if first is None:
            if not np.array_equal(seq_g[b], seq_w[b]):
                failed.append(f"{what}: row {b}: every decision equal, the "
                              f"sequences not")
            elif np.abs(sc_g[b] - sc_w[b]).max() > score_tol:
                failed.append(f"{what}: row {b}: scores differ by "
                              f"{np.abs(sc_g[b] - sc_w[b]).max():.3e}, "
                              f"beyond {score_tol:.3e}")
            continue
        if first >= min(len(got_calls), len(want_calls)):
            failed.append(f"{what}: row {b}: the searches ran "
                          f"{len(got_calls) // 3} and {len(want_calls) // 3}"
                          f" steps")
            continue
        margin = _decision_margin(want_calls[first][0][b],
                                  want_calls[first][1][b],
                                  got_calls[first][1][b][:-1])
        margins.append(margin)
        print(f"beam: {what}: row {b} first differs at decision {first} "
              f"(step {first // 3}); margin {margin:.3e}", flush=True)
        if margin >= NEAR_TIE:
            failed.append(f"{what}: row {b} differs at decision {first} at "
                          f"a margin of {margin:.3e} (not a near-tie)")
    return margins


@contextmanager
def logit_peaks(model):
    """The largest |logit| of each ``model.decode_step`` call in the block
    (appended to the yielded list)."""
    peaks = []
    step = model.decode_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        peaks.append(float(out[0].abs().max()))
        return out
    model.decode_step = recording
    try:
        yield peaks
    finally:
        del model.decode_step


@contextmanager
def counted_calls(obj, *names):
    """Count the calls of ``obj``'s methods ``names`` (instance attributes
    shadowing them for the block)."""
    calls = dict.fromkeys(names, 0)

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    for name in names:
        setattr(obj, name, counting(name, getattr(obj, name)))
    try:
        yield calls
    finally:
        for name in names:
            delattr(obj, name)


def _beam_prompts(vocab: int):
    rng = np.random.default_rng(51)
    prompts = np.zeros((BEAM_ROWS, BEAM_TP), np.int64)
    for i, n in enumerate(rng.integers(*BEAM_PROMPT, BEAM_ROWS)):
        prompts[i, BEAM_TP - n:] = rng.integers(1, vocab + 1, n)
    return prompts


def _synced(fn):
    """(fn(), host seconds to the device's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def beam_lm_reading(device: str = "cuda", lm=None) -> dict:
    """The serving LM's ``generate_beam`` (8 prompts of 16-128 tokens,
    left-padded to 128; beam 4, 32 new tokens, alpha 0.6) with no EOS and
    with an EOS the model emits (row 0's first greedy token), each held
    against a CPU copy (beams_held); beam 1 against greedy ``generate()``
    on the card (rows_held); three timed searches.  #1 at layers x (prefills
    + decode steps), all scalar.  Returns the readings and the failed
    checks."""
    import copy
    lm = serving_lm(device) if lm is None else lm
    layers = len(lm.blocks)
    vocab = lm.embedding.weight.shape[0] - 1
    prompts = _beam_prompts(vocab)
    beam = dict(beam_size=BEAM_SIZE, max_new_tokens=BEAM_NEW,
                alpha=BEAM_ALPHA)
    failed, r = [], {}
    cpu = copy.deepcopy(lm).to("cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with counted_calls(lm, "prefill_kv", "decode_step") as calls, \
            torch.no_grad():
        eos = int(lm.generate(prompts, 1)[0, -1])
        with recorded_decisions() as card_free:
            free = lm.generate_beam(prompts, eos_id=-1, **beam)
        steps = calls["decode_step"]
        with recorded_decisions() as card_eos:
            stop = lm.generate_beam(prompts, eos_id=eos, **beam)
        eos_steps = calls["decode_step"] - steps
        beam1 = lm.generate_beam(prompts, beam_size=1,
                                 max_new_tokens=BEAM_NEW)
        greedy = lm.generate(prompts, BEAM_NEW)
        times = [_synced(lambda: lm.generate_beam(prompts, eos_id=-1,
                                                  **beam))[1]
                 for _ in range(BEAM_TIMED)]
    torch.cuda.synchronize()
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    r["launches"], r["routes"] = _read_counts(), _read_routes()
    r["kernels"] = _read_kernels()
    r["calls"], r["eos"], r["eos_steps"] = dict(calls), eos, eos_steps
    # the calls the runs above make: 5 + BEAM_TIMED prefills; the steps of
    # greedy 1 + 32, two full searches, the timed ones and the EOS
    # search's own
    want_calls = {"prefill_kv": 5 + BEAM_TIMED,
                  "decode_step": 1 + BEAM_NEW * (3 + BEAM_TIMED) + eos_steps}
    if dict(calls) != want_calls or not 0 < eos_steps <= BEAM_NEW:
        failed.append(f"calls {dict(calls)}, not {want_calls} (the EOS "
                      f"search ran {eos_steps} steps)")
    got = r["launches"]["flash_attention_fwd"]
    want = layers * sum(want_calls.values())
    if got != want or not routes_are(r["routes"]["flash_attention_fwd"],
                                     {"scalar": want}):
        failed.append(f"#1 launched {got} times by "
                      f"{r['routes']['flash_attention_fwd']}, not {want} "
                      f"scalar = layers x (prefills + decode steps)")
    failed += kernels_held(r["kernels"], layers * want_calls["decode_step"],
                           layers * want_calls["prefill_kv"], "beam_lm")
    for name, n in r["launches"].items():
        if name != "flash_attention_fwd" and n:
            failed.append(f"{name} launched {n} times")
    with recorded_decisions() as cpu_free, logit_peaks(cpu) as peaks:
        want_free = cpu.generate_beam(prompts, eos_id=-1, **beam)
    with recorded_decisions() as cpu_eos:
        want_stop = cpu.generate_beam(prompts, eos_id=eos, **beam)
    r["logit_peak"] = max(peaks)
    r["score_err"] = max(float((a[1].cpu() - b[1]).abs().max())
                         for a, b in ((free, want_free), (stop, want_stop)))
    r["margins"] = (
        beams_held(free, want_free, card_free, cpu_free,
                   "beam_lm no EOS: card vs CPU", failed, r["logit_peak"])
        + beams_held(stop, want_stop, card_eos, cpu_eos,
                     "beam_lm EOS: card vs CPU", failed, r["logit_peak"]))
    for label, (seqs, scores) in (("no EOS", free), ("EOS", stop)):
        if tuple(seqs.shape) != (BEAM_ROWS, BEAM_SIZE, BEAM_NEW) \
                or not torch.isfinite(scores).all():
            failed.append(f"{label}: sequences {tuple(seqs.shape)} or "
                          f"scores not finite")
    seqs = stop[0].cpu().numpy()
    hit = seqs == eos
    after = (np.cumsum(hit, -1) - hit) > 0
    if not hit[0].any() or (seqs[after] != 0).any():
        failed.append("EOS: row 0 never emits the EOS, or a position after "
                      "an EOS is not 0")
    r["finished_rows"] = int(hit.any(-1).any(-1).sum())
    one = np.concatenate([prompts, beam1[0][:, 0].cpu().numpy()], 1)
    r["beam1_margins"] = rows_held(lm, list(prompts), list(one),
                                   list(greedy.cpu().numpy()),
                                   "beam_lm: beam 1 vs greedy", failed)
    t = float(np.median(times))
    r["search_s"] = t
    r["tokens_per_s"] = BEAM_ROWS * BEAM_NEW / t
    r["hypothesis_tokens_per_s"] = BEAM_ROWS * BEAM_SIZE * BEAM_NEW / t
    r["ms_per_step"] = t / BEAM_NEW * 1e3
    r["cache_bytes"] = (layers * 2 * BEAM_ROWS * BEAM_SIZE * MAX_LEN
                        * HIDDEN * 4)
    r["failed"] = failed
    return r


def translation_reading(device: str = "cuda", model=None) -> dict:
    """The Transformer-base translation model: 8 sources of 16-128 tokens
    0-padded to 128, ``encode``, ``init_decode_cache(8, 64, enc_out=)``
    and ``SequenceBeamSearch`` (beam 4, 64 steps at most, alpha 0.6, EOS
    row 0's first greedy index) over ``decode_step``, the encoder output
    and bias riding in the cache; held against a CPU copy (beams_held).
    ``decode_step`` against ``decode()`` of the best hypotheses' first 32
    tokens (F32_TOL), and a teacher-forced bf16 ``forward(src, tgt)`` at
    Tt 64 timed.  #1 at layers x (encodes + 2 x decode steps + 2 x
    decodes) scalar and 3 x layers a bf16 forward on the tensor cores."""
    import copy
    from bigdl_tpu_torch.core.module import cast_floating
    from bigdl_tpu_torch.nn import SequenceBeamSearch
    model = translation_model(device) if model is None else model
    layers = len(model.decoder_layers)
    vocab = model.vocab_size
    rng = np.random.default_rng(61)
    src = np.zeros((BEAM_ROWS, SRC_LEN), np.int64)
    for i, n in enumerate(rng.integers(16, SRC_LEN + 1, BEAM_ROWS)):
        src[i, :n] = rng.integers(1, vocab + 1, n)
    tgt_teacher = rng.integers(1, vocab + 1, (BEAM_ROWS, TEACHER_TT))
    failed, r = [], {}
    cpu = copy.deepcopy(model).to("cpu")
    half = cast_floating(model, torch.bfloat16)

    def search(m, eos):
        enc_out, enc_bias = m.encode(src)
        state = {"layers": m.init_decode_cache(BEAM_ROWS, TGT_MAX,
                                               enc_out=enc_out),
                 "enc_out": enc_out, "enc_bias": enc_bias}
        bs = SequenceBeamSearch(vocab, BEAM_SIZE, BEAM_ALPHA, TGT_MAX, eos,
                                device=m.device)

        def logits_fn(ids, i, st):
            # logit index j is token j + 1; the start id 0 stays 0
            logits, caches = m.decode_step(ids + (i > 0), i, st["layers"],
                                           st["enc_out"], st["enc_bias"])
            return logits, dict(st, layers=caches)
        bs.set_logit_fn(logits_fn)
        return bs.search(BEAM_ROWS, state), bs.steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with counted_calls(model, "encode", "decode_step", "decode") as calls, \
            torch.no_grad():
        enc_out, enc_bias = model.encode(src)
        first, _ = model.decode_step(
            np.zeros((BEAM_ROWS, 1), np.int64), 0,
            model.init_decode_cache(BEAM_ROWS, TGT_MAX, enc_out=enc_out),
            enc_out, enc_bias)
        eos = int(first[0].argmax())
        with recorded_decisions() as card_calls:
            got, steps = search(model, eos)
        times = [_synced(lambda: search(model, eos))[1]
                 for _ in range(BEAM_TIMED)]
        # decode_step against decode() on the best hypotheses' prefix
        tgt = (got[0][:, 0, :TGT_CHECK] + 1).cpu().numpy()
        full = model.decode(tgt, enc_out, enc_bias)
        caches = model.init_decode_cache(BEAM_ROWS, TGT_MAX, enc_out=enc_out)
        shifted = np.concatenate([np.zeros((BEAM_ROWS, 1), np.int64),
                                  tgt[:, :-1]], 1)
        errs = []
        for i in range(TGT_CHECK):
            step, caches = model.decode_step(shifted[:, i:i + 1], i, caches,
                                             enc_out, enc_bias)
            errs.append(float((step - full[:, i]).abs().max()))
            if not torch.allclose(step, full[:, i], **F32_TOL):
                failed.append(f"decode_step {i} differs from decode() by "
                              f"{errs[-1]:.3e}")
    r["steps_max_abs_err"] = max(errs)
    torch.cuda.synchronize()
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        out = half(src, tgt_teacher)           # warm-up
        teacher_ms = []
        for _ in range(TEACHER_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = half(src, tgt_teacher)
            end.record()
            end.synchronize()
            teacher_ms.append(start.elapsed_time(end))
    r["launches"], r["routes"] = _read_counts(), _read_routes()
    r["kernels"] = _read_kernels()
    r["calls"], r["steps"], r["eos"] = dict(calls), steps, eos
    if tuple(out.shape) != (BEAM_ROWS, TEACHER_TT, vocab) \
            or not torch.isfinite(out).all():
        failed.append(f"bf16 forward: {tuple(out.shape)} or not finite")
    forwards = 1 + TEACHER_TIMED
    # the calls the runs above make: 2 + BEAM_TIMED encodes, a first step,
    # the searches' steps and TGT_CHECK steps, one decode()
    want_calls = {"encode": 2 + BEAM_TIMED,
                  "decode_step": 1 + steps * (1 + BEAM_TIMED) + TGT_CHECK,
                  "decode": 1}
    if dict(calls) != want_calls:
        failed.append(f"calls {dict(calls)}, not {want_calls}")
    scalar = layers * (want_calls["encode"] + 2 * want_calls["decode_step"]
                       + 2 * want_calls["decode"])
    want = {"scalar": scalar, "tensor_core": 3 * layers * forwards}
    got_routes = r["routes"]["flash_attention_fwd"]
    if not routes_are(got_routes, want) or \
            r["launches"]["flash_attention_fwd"] != sum(want.values()):
        failed.append(f"#1 took {got_routes}, not {want}")
    # a decode step attends twice a layer at Tq 1 (self and cross), an
    # encode once and decode() twice at Tq > 1
    failed += kernels_held(
        r["kernels"], 2 * layers * want_calls["decode_step"],
        layers * (want_calls["encode"] + 2 * want_calls["decode"]),
        "translation_beam", tensor_core=want["tensor_core"])
    with torch.no_grad(), recorded_decisions() as cpu_calls, \
            logit_peaks(cpu) as peaks:
        want_out, _ = search(cpu, eos)
    r["logit_peak"] = max(peaks)
    r["score_err"] = float((got[1].cpu() - want_out[1]).abs().max())
    r["margins"] = beams_held(got, want_out, card_calls, cpu_calls,
                              "translation: card vs CPU", failed,
                              r["logit_peak"])
    t = float(np.median(times))
    r["search_s"], r["ms_per_step"] = t, t / steps * 1e3
    r["tokens_per_s"] = BEAM_ROWS * steps / t
    r["teacher_forced_bf16_ms"] = float(np.median(teacher_ms))
    r["finished_rows"] = int((got[0] == eos).any(-1).any(-1).sum())
    r["failed"] = failed
    return r


def _pool_bytes(pool):
    """(K/V bytes of a slot pool, the same K/V in f32)."""
    kv = [t for c in pool.caches["layers"] for t in c["self"].values()]
    return (sum(t.numel() * t.element_size() for t in kv),
            sum(t.numel() * 4 for t in kv), {t.dtype for t in kv})


@contextmanager
def counted_prefills(engines):
    """Count the engines' pools' prefill calls: ``dense`` (prefill_into
    of more than one token: prefill_kv, fresh f32 K/V) and ``chunk``
    (chunk_prefill_into: prefill_chunk, which reads the pool's cache)."""
    calls = {"dense": 0, "chunk": 0}
    saved = []
    for e in engines:
        pool = e.pool
        dense, chunk = pool.prefill_into, pool.chunk_prefill_into

        def prefill_into(prompts, slot_ids, bucket, dense=dense):
            calls["dense"] += bucket > 1
            return dense(prompts, slot_ids, bucket)

        def chunk_prefill_into(toks, slot, index, chunk=chunk):
            calls["chunk"] += 1
            return chunk(toks, slot, index)
        pool.prefill_into, pool.chunk_prefill_into = (prefill_into,
                                                      chunk_prefill_into)
        saved.append(pool)
    try:
        yield calls
    finally:
        for pool in saved:
            del pool.prefill_into, pool.chunk_prefill_into


def bf16_kv_reading(device: str = "cuda", lm=None) -> dict:
    """The serving LM (f32) with a bf16 KV cache: the serving phase's 32
    requests through ``GenerationScheduler(dtype=torch.bfloat16)``, held
    against a CPU engine with the same bf16 cache (rows_held); the prefix
    phase's shared-prefix requests (256-token prefix, tails of 8-64, 16
    new tokens) with the prefix cache on against off.  The pool's tensors
    bf16, half the f32 pool's bytes; #1 by its mixed entry on every decode
    step and chunk prefill (layers x (chunk calls + decode steps)), the
    dense prefill of fresh K/V f32 scalar (layers x its calls)."""
    import copy
    from bigdl_tpu_torch.serving import GenerationScheduler
    lm = serving_lm(device) if lm is None else lm
    layers = len(lm.blocks)
    vocab = lm.embedding.weight.shape[0] - 1
    bf = torch.bfloat16
    cfg = dict(slots=SLOTS, prefill_chunk=PREFILL_CHUNK,
               prefill_batch=PREFILL_BATCH, dtype=bf, start=False)
    prompts, max_news = _traffic()
    failed, r = [], {}
    cpu = copy.deepcopy(lm).to("cpu")
    rng = np.random.default_rng(71)
    prefix = rng.integers(1, vocab + 1, PREFIX_LEN).astype(np.int32)
    shared = _prefix_prompts(rng, prefix, N_REQUESTS, PREFIX_TAIL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    served = GenerationScheduler(lm, device=device, **cfg)
    on = GenerationScheduler(lm, prefix_cache_bytes=1 << 28,
                             prefix_granularity=PREFIX_G, device=device,
                             **cfg)
    off = GenerationScheduler(lm, device=device, **cfg)
    engines = (served, on, off)
    r["pool_bytes"], r["pool_bytes_f32"], dtypes = _pool_bytes(served.pool)
    try:
        with counted_prefills(engines) as calls:
            futs = [served.submit_async(p, m)
                    for p, m in zip(prompts, max_news)]
            t0 = time.perf_counter()
            served.start()
            rows = [f.result(timeout=600) for f in futs]
            r["served_s"] = time.perf_counter() - t0
            # a first wave stores the prefix, the rest hit it
            rows_on = (_serve_all(on, shared[:SLOTS // 4], PREFIX_NEW,
                                  start=True)
                       + _serve_all(on, shared[SLOTS // 4:], PREFIX_NEW))
            rows_off = _serve_all(off, shared, PREFIX_NEW, start=True)
    finally:
        for e in engines:
            e.shutdown()
    torch.cuda.synchronize()
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    r["launches"], r["routes"] = _read_counts(), _read_routes()
    r["kernels"] = _read_kernels()
    stats = [e.stats() for e in engines]
    steps = sum(s["decode_steps"] for s in stats)
    prefills = sum(s["prefill_calls"] for s in stats)
    r["calls"] = dict(calls, decode_steps=steps, prefill_calls=prefills)
    r["tokens_per_s"] = stats[0]["tokens_emitted"] / r["served_s"]
    r["prefix_cache"] = stats[1]["prefix_cache"]
    r["chunks_copied"] = stats[1]["prefix_chunks_copied"]
    if dtypes != {bf} or 2 * r["pool_bytes"] != r["pool_bytes_f32"]:
        failed.append(f"the pool holds {dtypes} in {r['pool_bytes']} bytes,"
                      f" not bf16 in half of {r['pool_bytes_f32']}")
    if calls["dense"] + calls["chunk"] != prefills:
        failed.append(f"{calls} prefill calls counted, the engines "
                      f"{prefills}")
    want = {"scalar": layers * calls["dense"],
            "mixed_kv": layers * (calls["chunk"] + steps)}
    if not routes_are(r["routes"]["flash_attention_fwd"], want) \
            or not want["mixed_kv"]:
        failed.append(f"#1 took {r['routes']['flash_attention_fwd']}, not "
                      f"{want}")
    failed += kernels_held(r["kernels"], layers * steps,
                           layers * prefills, "serving_bf16_kv", exact=False)
    if not (r["prefix_cache"]["hits"] > 0 and r["chunks_copied"] > 0):
        failed.append("shared prefix: no hit, or no chunk copied")
    engine = GenerationScheduler(cpu, device="cpu", **cfg)
    try:
        futs = [engine.submit_async(p, m) for p, m in zip(prompts, max_news)]
        engine.start()
        want_rows = [f.result(timeout=600) for f in futs]
    finally:
        engine.shutdown()
    r["cpu_margins"] = rows_held(lm, prompts, rows, want_rows,
                                 "bf16 cache: card vs CPU", failed)
    r["prefix_margins"] = rows_held(lm, shared, rows_on, rows_off,
                                    "bf16 cache: prefix cache on vs off",
                                    failed)
    r["failed"] = failed
    return r


def beam_reading(device: str = "cuda") -> dict:
    lm = beam_lm_reading(device)
    translation = translation_reading(device)
    bf16_kv = bf16_kv_reading(device)
    return {"lm": lm, "translation": translation, "bf16_kv": bf16_kv,
            "failed": [f"beam_lm: {f}" for f in lm["failed"]]
            + [f"translation_beam: {f}" for f in translation["failed"]]
            + [f"serving_bf16_kv: {f}" for f in bf16_kv["failed"]]}


def phase_beam(smi, device: str = "cuda"):
    """5d: beam search and the bf16 KV cache; see beam_lm_reading,
    translation_reading and bf16_kv_reading."""
    def report(r):
        lm, tr, kv = r["lm"], r["translation"], r["bf16_kv"]
        print(f"beam: beam_lm L{LAYERS} H{HIDDEN} vocab {VOCAB}, "
              f"{BEAM_ROWS} prompts left-padded to {BEAM_TP}, beam "
              f"{BEAM_SIZE}, {BEAM_NEW} new tokens: a search "
              f"{lm['search_s']:.5f} s = {lm['tokens_per_s']:.2f} new "
              f"tokens/s ({lm['hypothesis_tokens_per_s']:.2f} hypothesis "
              f"tokens/s), {lm['ms_per_step']:.4f} ms a step with the "
              f"prefill; EOS {lm['eos']} stops after {lm['eos_steps']} "
              f"steps, {lm['finished_rows']} rows finished; replicated "
              f"cache {lm['cache_bytes']} bytes; peak memory "
              f"{lm['peak_memory_bytes']} bytes; #1 "
              f"{lm['routes']['flash_attention_fwd']} {lm['kernels']}; "
              f"near-ties "
              f"{len(lm['margins'])} (vs CPU), {len(lm['beam1_margins'])} "
              f"(beam 1 vs greedy); scores within {lm['score_err']:.3e} of "
              f"the CPU's (logits up to {lm['logit_peak']:.3f}); on {smi}",
              flush=True)
        print(f"beam: translation_beam H{HIDDEN} filter {TRANSLATION_FILTER}"
              f" {TRANSLATION_LAYERS}+{TRANSLATION_LAYERS} layers, "
              f"{BEAM_ROWS} sources of up to {SRC_LEN}, beam {BEAM_SIZE}: "
              f"{tr['steps']} steps in {tr['search_s']:.5f} s = "
              f"{tr['ms_per_step']:.4f} ms a step, {tr['tokens_per_s']:.2f}"
              f" tokens/s; {tr['finished_rows']} rows finished; decode_step"
              f" within {tr['steps_max_abs_err']:.3e} of decode(); bf16 "
              f"teacher-forced forward at Tt {TEACHER_TT} "
              f"{tr['teacher_forced_bf16_ms']:.4f} ms (CUDA events); peak "
              f"memory {tr['peak_memory_bytes']} bytes; #1 "
              f"{tr['routes']['flash_attention_fwd']} {tr['kernels']}; "
              f"near-ties "
              f"{len(tr['margins'])}; scores within {tr['score_err']:.3e} "
              f"of the CPU's (logits up to {tr['logit_peak']:.3f}); on "
              f"{smi}", flush=True)
        print(f"beam: serving_bf16_kv: pool K/V {kv['pool_bytes']} bytes "
              f"bf16 against {kv['pool_bytes_f32']} f32; 32 requests in "
              f"{kv['served_s']:.4f} s = {kv['tokens_per_s']:.2f} tokens/s "
              f"(host clock); calls {kv['calls']}; prefix cache "
              f"{kv['prefix_cache']}, {kv['chunks_copied']} chunks copied; "
              f"peak memory {kv['peak_memory_bytes']} bytes; #1 "
              f"{kv['routes']['flash_attention_fwd']} {kv['kernels']}; "
              f"near-ties "
              f"{len(kv['cpu_margins'])} (vs CPU), "
              f"{len(kv['prefix_margins'])} (prefix on vs off); on {smi}",
              flush=True)
    return _phase("beam", lambda: beam_reading(device), report)


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
                  sides=("card", "cpu"), fed=None):
    """Hold a card step's ``(loss, grads)`` against the CPU's (or, with
    ``sides``, one step against another) and print the worst errors;
    returns (worst norm error, worst entry error, within ``bounds``: the
    loss's relative error, each gradient's norm error and its worst entry
    relative to its largest).  ``fed`` ({bias: weight},
    :func:`bn_fed_biases`) takes a BatchNorm-fed bias's errors relative
    to its layer's weight gradient: its own exact gradient is zero."""
    loss_rtol, grad_norm_rel, grad_max_rel = bounds
    (loss_card, g_card), (loss_cpu, g_cpu) = card, cpu
    scale = {n: g_cpu[(fed or {}).get(n, n)] for n in g_cpu}
    norm_rel = {n: float((g_card[n] - g_cpu[n]).norm()
                         / max(float(scale[n].norm()), 1e-30))
                for n in g_cpu}
    max_rel = {n: float((g_card[n] - g_cpu[n]).abs().max()
                        / max(float(scale[n].abs().max()), 1e-30))
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


# the kernel of torch.cuda._sleep, which frames a traced run (traced) and
# marks each capture on the device (mark_captures)
MARKER = "spin_kernel"

# torch.profiler's device trace can lose the records of a session's first
# few hundred milliseconds (a resnet run's first 250 ms once, marker
# kernels and all) and of its last few tens (the last dQ and dK/dV
# launches of a graph run's last replay, say): chip_trace_probe.py shows
# both.  So a traced run opens with TRACE_WARMUP_S of marker kernels,
# TRACE_PRIMER_S apart, for the trace to lose, and closes with a marker
# kernel and TRACE_MARGIN_S of the device idle
TRACE_WARMUP_S, TRACE_PRIMER_S, TRACE_MARGIN_S = 1.0, 0.02, 0.5

# it has also lost the whole of a block between markers it kept (33
# markers and none of five calls of a conv kernel, once in a smoke run
# that passed elsewhere): traced_call takes such a trace again, up to
# TRACE_ATTEMPTS traces in all
TRACE_ATTEMPTS = 3


class TraceLost(RuntimeError):
    """The profiler's trace of a traced() run lost its start or its end."""


@contextmanager
def traced():
    """``torch.profiler`` over the block's device work, framed: marker
    kernels for TRACE_WARMUP_S, the last just before the block, then the
    block, a marker and TRACE_MARGIN_S of the device idle.
    framed_events reads what lies between."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm = time.perf_counter() + TRACE_WARMUP_S
        while time.perf_counter() < warm:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_PRIMER_S)
        torch.cuda._sleep(1)
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def framed_events(prof):
    """The device's events of a traced() run between its leading markers
    and its last one, in the order they started.  Raises where the trace
    does not begin and end with a marker: it lost the run's start or
    end."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    first = next((i for i, e in enumerate(events) if MARKER not in e.name),
                 len(events))
    if first == 0 or first == len(events) or MARKER not in events[-1].name:
        raise TraceLost(
            "the profiler's trace does not begin and end with traced()'s "
            f"markers ({len(events)} device events, the first "
            f"{events[0].name if events else None!r}, the last "
            f"{events[-1].name if events else None!r}): it lost the start "
            "or the end of the run")
    return events[first:-1]


def traced_call(fn, prepare=None):
    """``fn(*prepare())`` with only ``fn`` under traced(): its result and
    the trace's framed_events.  Where the trace lost the run's start or
    end, it prints the loss, drops the result and takes a new trace of
    ``fn(*prepare())``, TRACE_ATTEMPTS traces in all, and raises the last
    loss; ``prepare`` builds afresh what a reading's run consumes (a
    model it trains).  No trace that lost events is read."""
    import gc
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        args = prepare() if prepare is not None else ()
        with traced() as prof:
            out = fn(*args)
        del args
        try:
            return out, framed_events(prof)
        except TraceLost as e:
            print(f"trace {attempt} of {TRACE_ATTEMPTS} lost events: {e}",
                  flush=True)
            if attempt == TRACE_ATTEMPTS:
                raise
        del out, prof
        gc.collect()


def device_events(framed):
    """framed_events but the dataset's upload (Memcpy HtoD)."""
    return [e for e in framed if "HtoD" not in e.name]


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
    from bigdl_tpu_torch.examples import perf
    short = argparse.Namespace(**{**vars(args), "iterations": BUSY_ITERS,
                                  "epochs": BUSY_EPOCHS})
    # left out when None: an older checkout's perf.run does not take it
    kw = {} if configure is None else {"configure": configure}
    (_, opt), framed = traced_call(
        lambda: perf.run(short, model, criterion, make_batch, **kw))
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(framed))
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


def dispatch_model(path, argv=None):
    """The path's model as its phase builds it (from ``argv`` where
    given, else the path's perf argv)."""
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(argv or DISPATCH_PATHS[path][0])
    model, criterion, make_batch = perf.build(args.model, args)
    if path == "sp":
        model.lm.set_sequence_parallel(seq_mesh(), "seq")
    return args, model, criterion, make_batch


def dispatch_reading(path, k, argv=None, then=None):
    """One timed run of the path with windows of ``k`` (1: eager) under
    ``torch.profiler``: its ms per iteration, peak memory, the wrappers'
    counts, and from the run's own device events its busy time and each
    kernel's launches before the capture's marker and after it (the
    replays').  ``argv`` and ``then(optimizer)`` (say, another optim
    method) as ``dispatch_model`` and ``dispatch_of`` take them."""
    from bigdl_tpu_torch.examples import perf

    def configured(opt):
        mark_captures(opt)
        if then is not None:
            then(opt)

    def prepare():
        built = dispatch_model(path, argv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        return built

    def run(args, model, criterion, make_batch):
        out, opt = perf.run(args, model, criterion, make_batch,
                            configure=dispatch_of(k, configured))
        return args, model, out, opt
    (args, model, out, opt), framed = traced_call(run, prepare)
    launches, routes = _read_counts(), _read_routes()
    peak = torch.cuda.max_memory_allocated()
    events = device_events(framed)
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


# ---------------------------------------------------------------------------
# 13b. resume: a crash, a torn checkpoint and a retry, in graph windows
# ---------------------------------------------------------------------------

# the LM of phase 6 for 3 epochs of 4 distinct shuffled batches in windows
# of 2 (graph replays); the faulted run checkpoints every epoch (keep 2),
# its 2nd checkpoint (generation 9) torn and a failure injected at
# iteration 11, inside epoch 3: the retry walks back to generation 5
RESUME_ITERS, RESUME_EPOCHS, RESUME_K, RESUME_FAIL_AT = 4, 3, 2, 11
RESUME_SEED, RESUME_FROM = 7, "checkpoint.5.npz"
RESUME_STEPS = {"clean": ([12], 1), "faulted": ([10, 8], 2)}


def mark_capture_spans(opt):
    """Put a marker kernel on the current stream before and after each of
    ``opt``'s captures: between a pair lies the warm-up step, after the
    second marker of a pair run that graph's replays."""
    capture = opt._capture

    def marked(*args):
        torch.cuda._sleep(1)
        step_graph = capture(*args)
        torch.cuda._sleep(1)
        return step_graph
    opt._capture = marked


def _untraced_run(run):
    """``run()`` unprofiled: its wall seconds (host clock, up to a
    synchronize), peak memory and the wrappers' counts and routes."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated(),
                launches=_read_counts(), routes=_read_routes())


def _traced_run(run, opt=None):
    """_untraced_run under traced(), each capture of ``opt`` (where
    given) between two marker kernels (mark_capture_spans), with, from
    the run's device events, its busy ms (kernels and sets, the dataset's
    host-to-device copies apart), those copies' ms, and each kernel's
    launches in each warm-up step and in each graph's replays."""
    if opt is not None:
        mark_capture_spans(opt)
    with traced() as prof:
        r = _untraced_run(run)
    framed = framed_events(prof)
    copies = [e for e in framed if "HtoD" in e.name]
    events = [e for e in framed if "HtoD" not in e.name]
    marks = [i for i, e in enumerate(events) if MARKER in e.name]
    spans = list(zip(marks[0::2], marks[1::2]))
    ends = [b for b, _ in spans[1:]] + [len(events)]
    replays = [kernel_launches(events[a + 1:e])
               for (_, a), e in zip(spans, ends)]
    return dict(r, marks=len(marks),
                warmups=[kernel_launches(events[b + 1:a]) for b, a in spans],
                replays=replays, replayed={n: sum(r[n] for r in replays)
                          for n in KERNEL_EVENTS},
                busy_us=sum(e.time_range.elapsed_us() for e in events
                            if MARKER not in e.name),
                copy_us=sum(e.time_range.elapsed_us() for e in copies))


def _phase(name, reading, report):
    """Run ``reading()`` (-> readings with a list of failed checks), print
    ``report(readings)``, then each failed check as ``<name>: FAILED:
    <check>``; raises if any failed."""
    t0 = time.perf_counter()
    try:
        r = reading()
    except Exception as e:
        print(f"{name}: FAILED: {type(e).__name__}: {e}", flush=True)
        raise
    report(r)
    if r["failed"]:
        for what in r["failed"]:
            print(f"{name}: FAILED: {what}", flush=True)
        raise RuntimeError(f"{name}: {len(r['failed'])} checks failed")
    print(f"{name}: passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return r


def resume_run(ckpt_dir=None):
    """One run of the resume phase under torch.profiler (the faulted one
    where ``ckpt_dir`` is given): the Optimizer, the wrappers' counts and
    routes, the checkpoints it restored, the faults that fired, and from
    its device events each kernel's launches in the warm-up steps and in
    each graph's replays."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils import chaos
    args, model, criterion, make_batch = dispatch_model("lm")
    data = DataSet.array([MiniBatch(*make_batch(args.batch_size))
                          for _ in range(RESUME_ITERS)],
                         seed=RESUME_SEED).cache_on_device(
                             next(model.parameters()).device)
    opt = (Optimizer(model, data, criterion, seed=0)
           .set_optim_method(SGD(args.learning_rate, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_epoch(RESUME_EPOCHS))
           .set_log_interval(RESUME_ITERS)
           .set_compute_dtype(torch.bfloat16)
           .set_iterations_per_dispatch(RESUME_K))
    restored, fired = [], []
    if ckpt_dir is not None:
        opt.set_checkpoint(str(ckpt_dir), Trigger.every_epoch(), keep_n=2) \
            .set_failure_retry(2, backoff_s=0.0, jitter=0.0)
        restore = opt._restore

        def recorded(path):
            restored.append(Path(path).name)
            return restore(path)
        opt._restore = recorded
        fired = chaos.install(fail_at_step=RESUME_FAIL_AT,
                              truncate_checkpoint=2).events
    try:
        r = _traced_run(opt.optimize, opt)
    finally:
        chaos.reset()
    return dict(r, opt=opt, model=model, restored=restored,
                fired=list(fired))


def resume_reading():
    """The resume phase's two runs and its checks: returns the readings
    and the list of checks that failed (empty: the faulted run is the
    uninterrupted one)."""
    import tempfile
    from bigdl_tpu_torch.utils.file import CheckpointManager
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    root = Path(__file__).resolve().parent
    with deterministic() as nondet, tempfile.TemporaryDirectory(
            prefix=".ckpt-", dir=root) as ckpt_dir:
        runs = {"clean": resume_run(), "faulted": resume_run(ckpt_dir)}
        latest = CheckpointManager(ckpt_dir).latest_good()
        payload_bytes = os.path.getsize(latest) if latest else 0
        written = sorted(n for n in os.listdir(ckpt_dir) if
                         n.endswith(".npz"))
    clean, faulted = runs["clean"], runs["faulted"]
    per_step = DISPATCH_PATHS["lm"][1]
    for label, r in runs.items():
        window_steps, captures = RESUME_STEPS[label]
        stats = {"single_steps": 0, "window_steps": sum(window_steps),
                 "captures": captures, "replays": sum(window_steps)}
        check(r["opt"].dispatch_stats == stats,
              f"{label} run dispatched {r['opt'].dispatch_stats}, not "
              f"{stats}")
        check(r["marks"] == 2 * captures,
              f"{label} run: {r['marks']} capture markers, not "
              f"{2 * captures}")
        for name, n in per_step.items():
            check(r["launches"][name] == 2 * n * captures,
                  f"{label} run: {name}'s wrapper counted "
                  f"{r['launches'][name]} launches, not {2 * n * captures}"
                  " (warm-up step and capture of each graph)")
            check(routes_are(r["routes"][name],
                             {"tensor_core": 2 * n * captures}),
                  f"{label} run: {name} took the routes "
                  f"{r['routes'][name]}")
            check([w[name] for w in r["warmups"]] == [n] * captures,
                  f"{label} run: {name} on the device in the warm-up "
                  f"steps {[w[name] for w in r['warmups']]}, not "
                  f"{[n] * captures}")
            check([p[name] for p in r["replays"]]
                  == [n * s for s in window_steps],
                  f"{label} run: {name} on the device in the replays "
                  f"{[p[name] for p in r['replays']]}, not "
                  f"{[n * s for s in window_steps]}")
    check(faulted["restored"] == [RESUME_FROM],
          f"the retry restored {faulted['restored']}, not [{RESUME_FROM}]")
    check(any("truncated" in e for e in faulted["fired"])
          and any(f"iteration {RESUME_FAIL_AT}" in e
                  for e in faulted["fired"]),
          f"the faults that fired: {faulted['fired']}")
    co, fo = clean["opt"], faulted["opt"]
    for key in ("epoch", "neval", "records", "loss", "score"):
        check(fo.state[key] == co.state[key],
              f"state {key}: faulted {fo.state[key]}, uninterrupted "
              f"{co.state[key]}")
    after = [x for x in fo.loss_history if x[0] > RESUME_ITERS][-8:]
    want = [x for x in co.loss_history if x[0] > RESUME_ITERS]
    check(after == want, f"losses after the resume point {after} differ "
          f"from the uninterrupted run's {want}")
    same_params = all(torch.equal(p, q) for p, q in zip(
        clean["model"].parameters(), faulted["model"].parameters()))
    check(same_params, "parameters differ from the uninterrupted run's")
    same_state = all(
        a["t"] == b["t"] and all(torch.equal(u, v) for u, v in zip(
            a["velocity"], b["velocity"]))
        for a, b in zip(co._opt_states, fo._opt_states))
    check(same_state, "the SGD state (t, velocity) differs from the "
          "uninterrupted run's")
    write_n = fo.metrics.get("checkpoint time")[1]
    return dict(
        failed=failed, nondeterministic=sorted(nondet),
        checkpoint_bytes=payload_bytes, checkpoints_written=write_n,
        kept=written,
        write_ms=fo.metrics.mean("checkpoint time") * 1e3,
        load_ms=fo.metrics.mean("checkpoint load time") * 1e3,
        clean_wall_s=clean["wall"], faulted_wall_s=faulted["wall"],
        restored=faulted["restored"], fired=faulted["fired"],
        dispatch={label: r["opt"].dispatch_stats
                  for label, r in runs.items()},
        replayed=faulted["replayed"],
        losses=[x for _, x in co.loss_history],
        same_params=same_params, same_state=same_state)


def phase_resume(smi):
    """The LM at phase 6's width in graph windows, uninterrupted and
    through a torn checkpoint, a failure and a retry: the faulted run must
    end where the uninterrupted one does, bit for bit, with #1-#3's
    replays counted on the device."""
    def report(r):
        print(f"resume: {RESUME_EPOCHS} epochs of {RESUME_ITERS} in windows "
              f"of {RESUME_K}: uninterrupted {r['clean_wall_s']:.3f} s, "
              f"faulted {r['faulted_wall_s']:.3f} s; faults {r['fired']}; "
              f"restored {r['restored']}; kept {r['kept']}; dispatch "
              f"{r['dispatch']}; #1-#3 replayed on the device (faulted run) "
              + ", ".join(f"{n} {r['replayed'][n]}" for n in DENSE_NAMES[:3])
              + f"; parameters {'equal' if r['same_params'] else 'DIFFER'}, "
              f"SGD state {'equal' if r['same_state'] else 'DIFFERS'} bit "
              f"for bit; operations without a deterministic implementation: "
              f"{r['nondeterministic'] or 'none'}")
        print(f"resume: checkpoint {r['checkpoint_bytes']} bytes, write "
              f"{r['write_ms']:.3f} ms (mean of {r['checkpoints_written']}), "
              f"load {r['load_ms']:.3f} ms, on {smi}")
    return _phase("resume", resume_reading, report)


# ---------------------------------------------------------------------------
# 13c-13e. remat, device prefetch and the asynchronous loss drain
# ---------------------------------------------------------------------------

def _steady_ms(opt) -> float:
    """ms per iteration over the windows after the first (completion to
    completion), as perf.run reads them."""
    steady = opt.window_timings[1:]
    return 1e3 * sum(dt for _, dt, _ in steady) / sum(n for n, _, _ in steady)


def _trained(model):
    """The model's parameters and buffers as a run left them."""
    return dict(params=[p.detach().clone() for p in model.parameters()],
                buffers=[b.detach().clone() for b in model.buffers()])


def _same_run(a, b):
    """Whether two runs' losses, parameters and buffers are equal bit for
    bit."""
    return a["opt"].loss_history == b["opt"].loss_history and all(
        torch.equal(p, q) for key in ("params", "buffers")
        for p, q in zip(a[key], b[key]))


# the LM of phase 6 with dropout 0.1 after the attention and in the FFN
# (the attention's own dropout stays off: it takes the materialised path,
# which would leave #1-#3), 2 epochs of 4 distinct batches, eagerly
# without and with remat and with remat in windows of 4 (graph replays)
REMAT_ITERS, REMAT_EPOCHS, REMAT_K, REMAT_DROPOUT = 4, 2, 4, 0.1
REMAT_RUNS = {"plain": (False, 1), "remat": (True, 1),
              "remat_graph": (True, REMAT_K)}
# #1-#3 a step: with remat the forward kernel runs again in each block's
# recompute
PLAIN_LAUNCHES = {n: LAYERS for n in DENSE_NAMES[:3]}
REMAT_LAUNCHES = dict(PLAIN_LAUNCHES, flash_attention_fwd=2 * LAYERS)


def remat_run(remat, k):
    """One run of the remat phase under traced()."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    args = perf.parse_args(TRAIN_ARGV + (["--remat"] if remat else []))
    model, criterion, make_batch = perf.build(args.model, args)
    for blk in model.lm.blocks:
        blk.ffn_dropout = blk.ffn.relu_dropout = REMAT_DROPOUT
    data = DataSet.array([MiniBatch(*make_batch(args.batch_size))
                          for _ in range(REMAT_ITERS)],
                         shuffle=False).cache_on_device(
                             next(model.parameters()).device)
    opt = (Optimizer(model, data, criterion, seed=0)
           .set_optim_method(SGD(args.learning_rate, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_epoch(REMAT_EPOCHS))
           .set_log_interval(REMAT_ITERS)
           .set_compute_dtype(torch.bfloat16)
           .set_iterations_per_dispatch(k))
    return dict(_traced_run(opt.optimize, opt), **_trained(model), opt=opt)


def remat_reading():
    """The remat phase's three runs and its checks: returns the readings
    and the list of checks that failed."""
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    with deterministic() as nondet:
        runs = {label: remat_run(remat, k)
                for label, (remat, k) in REMAT_RUNS.items()}
    steps = REMAT_ITERS * REMAT_EPOCHS
    losses = [x for _, x in runs["plain"]["opt"].loss_history]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses not finite or missing: {losses}")
    check(_same_run(runs["plain"], runs["remat"]),
          "remat eager is not plain eager bit for bit")
    check(_same_run(runs["remat"], runs["remat_graph"]),
          "remat in graph windows is not remat eager bit for bit")
    # eager: the wrappers count every launch
    for label, per_step in (("plain", PLAIN_LAUNCHES),
                            ("remat", REMAT_LAUNCHES)):
        r = runs[label]
        check(r["marks"] == 0, f"{label}: {r['marks']} capture markers")
        for name, n in per_step.items():
            check(r["launches"][name] == n * steps,
                  f"{label}: {name}'s wrapper counted {r['launches'][name]}"
                  f" launches, not {n} x {steps} steps")
            check(routes_are(r["routes"][name],
                             {"tensor_core": n * steps}),
                  f"{label}: {name} took the routes {r['routes'][name]}")
    # graph: the wrappers count the warm-up step and the capture; the
    # device events hold the warm-up step's launches between the markers
    # and the replays' after them
    g = runs["remat_graph"]
    stats = {"single_steps": 0, "window_steps": steps, "captures": 1,
             "replays": steps}
    check(g["opt"].dispatch_stats == stats,
          f"remat_graph dispatched {g['opt'].dispatch_stats}, not {stats}")
    check(g["marks"] == 2, f"remat_graph: {g['marks']} capture markers, "
          "not 2")
    for name, n in REMAT_LAUNCHES.items():
        check(g["launches"][name] == 2 * n,
              f"remat_graph: {name}'s wrapper counted {g['launches'][name]}"
              f" launches, not {2 * n} (warm-up step and capture)")
        check(routes_are(g["routes"][name], {"tensor_core": 2 * n}),
              f"remat_graph: {name} took the routes {g['routes'][name]}")
        check([w[name] for w in g["warmups"]] == [n],
              f"remat_graph: {name} on the device in the warm-up step "
              f"{[w[name] for w in g['warmups']]}, not [{n}]")
        check(g["replayed"][name] == n * steps,
              f"remat_graph: {name} on the device in the replays "
              f"{g['replayed'][name]}, not {n} x {steps}")
    return dict(failed=failed, nondeterministic=sorted(nondet), steps=steps,
                runs={label: dict(ms=_steady_ms(r["opt"]), peak=r["peak"],
                                  wall=r["wall"], launches=r["launches"],
                                  replayed=r["replayed"])
                      for label, r in runs.items()},
                losses=losses)


def phase_remat(smi):
    """The LM at phase 6's width with dropout, eagerly without and with
    remat and with remat in graph windows: all three bit for bit one run,
    #1/#2/#3 at 12/6/6 launches a step with remat."""
    def report(r):
        for label, x in r["runs"].items():
            print(f"remat: {label}: {x['ms']:.3f} ms/iteration (steady "
                  f"windows, under torch.profiler), peak memory "
                  f"{x['peak']} bytes, {r['steps']} steps in "
                  f"{x['wall']:.3f} s; #1-#3 by the wrappers "
                  + ", ".join(f"{n} {x['launches'][n]}"
                              for n in DENSE_NAMES[:3])
                  + "; in the replays on the device "
                  + ", ".join(f"{n} {x['replayed'][n]}"
                              for n in DENSE_NAMES[:3]))
        print(f"remat: losses {r['losses']}; operations without a "
              f"deterministic implementation: "
              f"{r['nondeterministic'] or 'none'}; on {smi}")
    return _phase("remat", remat_reading, report)


# ResNet-50 of phase 9 on a host-resident dataset (not cached on the
# card): 4 distinct batches as perf.build's image_batch makes them, for 3
# epochs, eagerly, without device prefetch and with set_device_prefetch(2):
# timed unprofiled in turns (off, on, on, off; torch.profiler's tracing of
# two threads' CUDA calls slows the host), then profiled once each for the
# device's busy time
PREFETCH_ITERS, PREFETCH_EPOCHS, PREFETCH_AHEAD = 4, 3, 2
PREFETCH_TURNS = (0, PREFETCH_AHEAD, PREFETCH_AHEAD, 0)
PREFETCH_THREAD = "bigdl-device-prefetch"


def prefetch_run(ahead, setup, profiled):
    """One run of the prefetch phase from ``setup``'s initial weights over
    its host batches (under traced() where ``profiled``), with the
    batches its DevicePrefetch iterators staged and the producer threads
    alive after it."""
    import threading
    from bigdl_tpu_torch.data.device_prefetch import DevicePrefetch
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    args, model, criterion, init, batches = setup
    model.load_state_dict(init)
    opt = (Optimizer(model, DataSet.array(batches, shuffle=False),
                     criterion, seed=0)
           .set_optim_method(SGD(args.learning_rate, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_epoch(PREFETCH_EPOCHS))
           .set_log_interval(PREFETCH_ITERS)
           .set_compute_dtype(torch.bfloat16)
           .set_device_prefetch(ahead))
    iters = []
    apply = DevicePrefetch.apply

    def recorded(self, it):
        iters.append(apply(self, it))
        return iters[-1]
    DevicePrefetch.apply = recorded
    try:
        r = (_traced_run(opt.optimize, opt) if profiled
             else _untraced_run(opt.optimize))
    finally:
        DevicePrefetch.apply = apply
    return dict(r, **_trained(model), opt=opt, ahead=ahead,
                ms=_steady_ms(opt),
                staged=sum(i.staged_total for i in iters),
                alive=[t.name for t in threading.enumerate()
                       if t.name == PREFETCH_THREAD and t.is_alive()])


def prefetch_reading():
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.examples import perf
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    # one model, put back to its initial weights before each run
    args = perf.parse_args(RESNET_ARGV)
    model, criterion, make_batch = perf.build(args.model, args)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [MiniBatch(*make_batch(args.batch_size))
               for _ in range(PREFETCH_ITERS)]
    setup = (args, model, criterion, init, batches)
    with deterministic() as nondet:
        timed = [prefetch_run(a, setup, False) for a in PREFETCH_TURNS]
        profiled = {label: prefetch_run(a, setup, True)
                    for label, a in (("off", 0), ("on", PREFETCH_AHEAD))}
    steps = PREFETCH_ITERS * PREFETCH_EPOCHS
    runs = [*timed, *profiled.values()]
    check(all(_same_run(runs[0], r) for r in runs[1:]),
          "the runs with device prefetch are not the runs without it bit "
          "for bit")
    for i, r in enumerate(runs):
        label = f"run {i} (n_ahead {r['ahead']})"
        check(r["staged"] == (steps if r["ahead"] else 0),
              f"{label}: staged {r['staged']} batches")
        check(not r["alive"], f"{label}: {r['alive']} alive after "
              "optimize()")
        want = {n: RESNET_LAUNCHES.get(n, 0) * steps for n in r["launches"]}
        check(r["launches"] == want,
              f"{label}: launches {r['launches']} != {want}")
        for name in TC_CONV:
            check(r["routes"][name] == {"tensor_core": want[name],
                                        "scalar": 0},
                  f"{label}: {name} took the routes {r['routes'][name]}")
    losses = [x for _, x in runs[0]["opt"].loss_history]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses not finite or missing: {losses}")
    step_bytes = sum(b.get_input().nbytes + b.get_target().nbytes
                     for b in batches) // len(batches)
    return dict(failed=failed, nondeterministic=sorted(nondet), steps=steps,
                step_bytes=step_bytes,
                runs={label: dict(
                    ms=[r["ms"] for r in timed if r["ahead"] == p["ahead"]],
                    peak=p["peak"], staged=p["staged"],
                    busy_ms=p["busy_us"] / steps / 1e3,
                    copy_ms=p["copy_us"] / steps / 1e3)
                    for label, p in profiled.items()},
                launches=profiled["on"]["launches"])


def phase_prefetch(smi):
    """ResNet-50 on host-resident batches, without and with device
    prefetch: the same run bit for bit, the batches staged ahead, #8-#11
    at 32/32/13/13 a step, no producer thread left."""
    def report(r):
        for label, x in r["runs"].items():
            ms = float(np.mean(x["ms"]))
            print(f"prefetch: {label}: {r['step_bytes']} bytes staged a "
                  f"step; {' and '.join(f'{m:.3f}' for m in x['ms'])} "
                  f"ms/iteration (steady windows, the first excluded, "
                  f"unprofiled, in turns off, on, on, off); device busy "
                  f"{x['busy_ms']:.3f} ms a step (torch.profiler over a "
                  f"run of its own: kernels, the dataset's copies apart: "
                  f"{x['copy_ms']:.3f} ms of host-to-device copies a step), "
                  f"idle share {1 - x['busy_ms'] / ms:.3f} of the mean "
                  f"{ms:.3f} ms; {x['staged']} batches staged ahead; peak "
                  f"memory {x['peak']} bytes")
        print(f"prefetch: operations without a deterministic "
              f"implementation: {r['nondeterministic'] or 'none'}; on {smi}")
    return _phase("prefetch", prefetch_reading, report)


# LeNet-5 of phase 12 (b256, f32, eager), 2 epochs of 50 with every loss
# read: asynchronously (no trigger reads the loss) and synchronously
# (end_when OR'ed with a min_loss trigger that never fires), timed
# unprofiled in turns (async, sync, sync, async), then profiled once each
DRAIN_EPOCHS, DRAIN_THREAD = 2, "bigdl-loss-drain"
DRAIN_TURNS = (False, True, True, False)


def drain_run(sync, profiled):
    """One run of the drain phase (under traced() where ``profiled``),
    with the threads that logged its losses and the drain threads alive
    after it."""
    import logging
    import threading
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.optim import Trigger
    args = perf.parse_args(LENET_ARGV + ["--epochs", str(DRAIN_EPOCHS)])
    model, criterion, make_batch = perf.build(args.model, args)
    readers = set()

    class Readers(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith("Epoch %d %d/%d]"):
                readers.add(record.threadName)

    def configure(opt):
        opt.set_log_interval(1)
        if sync:
            opt.set_end_when(Trigger.or_(opt.end_when,
                                         Trigger.min_loss(-1.0)))
    out = {}

    def run():
        out["result"], out["opt"] = perf.run(args, model, criterion,
                                             make_batch, configure=configure)
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    handler, level = Readers(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        r = _traced_run(run) if profiled else _untraced_run(run)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return dict(r, **_trained(model), opt=out["opt"],
                ms=out["result"]["ms_per_iteration"], sync=sync,
                readers=readers,
                alive=[t.name for t in threading.enumerate()
                       if t.name == DRAIN_THREAD and t.is_alive()])


def drain_reading():
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)

    with deterministic() as nondet:
        timed = [drain_run(sync, False) for sync in DRAIN_TURNS]
        profiled = {label: drain_run(sync, True)
                    for label, sync in (("async", False), ("sync", True))}
    runs = [*timed, *profiled.values()]
    steps = runs[0]["opt"].state["neval"] - 1
    check(all(_same_run(runs[0], r) for r in runs[1:]),
          "the async runs are not the sync runs bit for bit")
    check(all(r["opt"].dispatch_stats == runs[0]["opt"].dispatch_stats
              for r in runs),
          f"dispatch_stats differ: {[r['opt'].dispatch_stats for r in runs]}")
    for i, r in enumerate(runs):
        label = f"run {i} ({'sync' if r['sync'] else 'async'})"
        if r["sync"]:
            check(DRAIN_THREAD not in r["readers"],
                  f"{label}: the losses were read on {r['readers']}")
        else:
            check(r["readers"] == {DRAIN_THREAD},
                  f"{label}: the losses were read on {r['readers']}")
        check(len(r["opt"].window_timings) == steps == 100,
              f"{label}: {len(r['opt'].window_timings)} window timings "
              f"over {steps} steps, not 100")
        check(not r["alive"], f"{label}: {r['alive']} alive after "
              "optimize()")
    return dict(failed=failed, nondeterministic=sorted(nondet), steps=steps,
                runs={label: dict(
                    ms=[r["ms"] for r in timed if r["sync"] == p["sync"]],
                    busy_ms=p["busy_us"] / steps / 1e3,
                    readers=sorted(p["readers"]),
                    dispatch=p["opt"].dispatch_stats)
                    for label, p in profiled.items()})


def phase_drain(smi):
    """LeNet-5 with every loss read, asynchronously on the drain thread and
    synchronously: the same run bit for bit, 100 window timings each, no
    drain thread left."""
    def report(r):
        for label, x in r["runs"].items():
            ms = float(np.mean(x["ms"]))
            print(f"drain: {label}: {' and '.join(str(m) for m in x['ms'])} "
                  f"ms/iteration (steady windows, unprofiled, in turns "
                  f"async, sync, sync, async); device busy "
                  f"{x['busy_ms']:.3f} ms a step (torch.profiler over a run "
                  f"of its own), idle share {1 - x['busy_ms'] / ms:.3f} of "
                  f"the mean {ms:.3f} ms; losses read on {x['readers']}; "
                  f"dispatch {x['dispatch']}")
        print(f"drain: operations without a deterministic implementation: "
              f"{r['nondeterministic'] or 'none'}; on {smi}")
    return _phase("drain", drain_reading, report)


# ---------------------------------------------------------------------------
# 13f. the zoo models of the perf CLI: Inception-v1/v2, VGG-16, the PTB LM
# ---------------------------------------------------------------------------

ZOO_IMAGE_MODELS = ("inception-v1", "inception-v2", "vgg16")
# two steady windows of 10 steps after the first (the build's)
ZOO_ITERS, ZOO_EPOCHS = 10, 3
# phase 9's shape (bench.py:1079-1080), so the five image models read side
# by side
ZOO_IMAGE_ARGV = ["-b", str(RESNET_BATCH), "--image-size", str(RESNET_SIZE),
                  "--classes", str(RESNET_CLASSES), "--bf16",
                  "--iterations", str(ZOO_ITERS), "--epochs", str(ZOO_EPOCHS)]
# the defaults of the repo's bigdl-tpu-ptb (bigdl_tpu/examples/ptb_lm.py:
# 20-30), f32, eagerly and in windows of an epoch
PTB_BATCH, PTB_SEQ, PTB_ITERS, PTB_EPOCHS = 32, 20, 10, 3
PTB_ARGV = ["--model", "ptb-lstm", "-b", str(PTB_BATCH), "--seq-len",
            str(PTB_SEQ), "--vocab-size", "10000", "--hidden-size", "200",
            "--num-layers", "2", "--iterations", str(PTB_ITERS),
            "--epochs", str(PTB_EPOCHS)]
# one f32 step of each model on the card against a CPU copy, TF32 off
# (phase 1), by parity_report's rules: phase 11's bounds for the image
# models, phase 7's for the PTB LM.  A ReLU or a max pool whose inputs
# lie within rounding of zero or of each other routes a gradient one way
# on the card and the other on the CPU, and each such flip moves a
# weight gradient summed from cancelling terms by a share of itself.  At
# 224 px and batch 2 such flips put the card's and the CPU's own f32
# steps of Inception-v2 2.8e-2 and 2.2e-2 in norm from a float64 step
# (on an H100 80GB HBM3 at 700 W), beyond the bounds, as VGG-16's
# default init (each layer shrinks its input's scale 2.4-fold) put VGG-16
# 3.5e-2 and 2.8e-2 off.  So the steps run where float32 is stable, as
# in test_torch_zoo_models.py: Inception-v1 at phase 11's 64 px, batch 4;
# Inception-v2 at 32 px, batch 8 (its last BatchNorms over 8 values),
# its BatchNorm biases drawn from U(-0.5, 0.5) and an input (seed 19)
# with no such tie; VGG-16 at 224 px (its head's size), batch 2, its
# weights scaled by sqrt(6) to He's variance 2 / fan_in
# (zoo_condition).  test_torch_zoo_models.py holds the CPU's f32 steps
# of both Inceptions there within 1e-3 of float64 and of a step on inputs
# moved by 2^-23; chip_gate_controls.py shows TF32 refused.
# model: (perf CLI arguments, the input's seed, bounds)
ZOO_PARITY = {
    "inception-v1": (["-b", "4", "--image-size", "64", "--classes",
                      str(RESNET_CLASSES)], 0, RESNET_PARITY_BOUNDS),
    "inception-v2": (["-b", "8", "--image-size", "32", "--classes",
                      str(RESNET_CLASSES)], 19, RESNET_PARITY_BOUNDS),
    "vgg16": (["-b", "2", "--image-size", str(RESNET_SIZE), "--classes",
               str(RESNET_CLASSES)], 0, RESNET_PARITY_BOUNDS),
    "ptb-lstm": (PTB_ARGV[2:], None, (LOSS_RTOL, GRAD_NORM_REL,
                                      GRAD_MAX_REL)),
}


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def zoo_image_run(model):
    """``perf.run`` of one image model at ZOO_IMAGE_ARGV, its wrappers'
    counts zeroed before and read after, then profile_steps on it."""
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(["--model", model, *ZOO_IMAGE_ARGV])
    built = perf.build(model, args)
    _free()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out, opt = perf.run(args, *built)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in opt.loss_history]
    del opt
    busy = profile_steps(args, *built)
    del built
    _free()
    return dict(out=out, wall=wall, launches=launches, peak=peak,
                losses=losses, busy=busy, steps=ZOO_ITERS * ZOO_EPOCHS)


def zoo_ptb_run(k):
    """The PTB LM at PTB_ARGV with windows of ``k`` (1: eager), then the
    device's busy time over a short run of a fresh copy."""
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(PTB_ARGV)
    model, criterion, make_batch = perf.build("ptb-lstm", args)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out, opt = perf.run(args, model, criterion, make_batch,
                        configure=dispatch_of(k))
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    busy = profile_steps(args, *perf.build("ptb-lstm", args),
                         configure=dispatch_of(min(k, BUSY_ITERS)))
    return dict(out=out, opt=opt, model=model, launches=launches, peak=peak,
                busy=busy, losses=[loss for _, loss in opt.loss_history])


def zoo_step(criterion, x, y):
    """:func:`grad_step` with the model's own criterion, each Dropout in
    eval mode (the card's and the CPU's generators draw different
    masks); ``dtype`` casts a floating input (float64 for an exact
    step)."""
    from bigdl_tpu_torch.nn import Dropout

    def step(model, device, dtype=None, perturb=None):
        model.train()
        for m in model.modules():
            if isinstance(m, Dropout):
                m.eval()
        model.zero_grad(set_to_none=True)
        xs = x
        if perturb is not None:
            sign = np.random.default_rng(perturb).choice([-1, 1], x.shape)
            xs = x * (1 + sign * 2.0 ** -23).astype(np.float32)
        xs = torch.as_tensor(xs, device=device)
        if dtype is not None and xs.is_floating_point():
            xs = xs.to(dtype)
        loss = criterion(model(xs), torch.as_tensor(y, device=device))
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu()
                                      for n, p in model.named_parameters()}
    return step


def bn_fed_biases(model):
    """{bias: its layer's weight} of the convolutions and linear layers
    that feed a BatchNorm in one of ``model``'s containers."""
    from bigdl_tpu_torch.nn import BatchNormalization, Linear, \
        SpatialConvolution
    out = {}
    for path, m in model.named_modules():
        layers = getattr(m, "layers", None)
        if layers is None:
            continue
        for i, (a, b) in enumerate(zip(layers, layers[1:])):
            if isinstance(a, (SpatialConvolution, Linear)) and \
                    a.bias is not None and \
                    isinstance(b, BatchNormalization):
                name = f"{path}.layers.{i}." if path else f"layers.{i}."
                out[name + "bias"] = name + "weight"
    return out


def zoo_condition(model, net):
    """ZOO_PARITY's conditioning of ``net``, in place: Inception-v2's
    BatchNorm biases drawn from U(-0.5, 0.5), VGG-16's weights scaled by
    sqrt(6)."""
    from bigdl_tpu_torch.nn import BatchNormalization, Linear, \
        SpatialConvolution
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if model == "inception-v2" and \
                    isinstance(m, BatchNormalization):
                m.bias.copy_(torch.rand(m.bias.shape, generator=gen) - 0.5)
            if model == "vgg16" and \
                    isinstance(m, (SpatialConvolution, Linear)):
                m.weight.mul_(6 ** 0.5)


def zoo_parity_setup(model, device="cuda"):
    """The perf build of ``model`` in f32 on ``device`` at ZOO_PARITY's
    size, conditioned (:func:`zoo_condition`), its CPU copy,
    :func:`zoo_step` over one batch (the image models' from ZOO_PARITY's
    seed, drawn as ``perf.build`` draws it), and the step's description."""
    import copy
    from bigdl_tpu_torch.examples import perf
    argv, seed, _ = ZOO_PARITY[model]
    args = perf.parse_args(["--model", model, *argv, "--device", device])
    net, criterion, make_batch = perf.build(model, args)
    zoo_condition(model, net)
    if seed is None:
        x, y = make_batch(args.batch_size)
        what = f"batch {args.batch_size}, T{args.seq_len}"
    else:
        rng = np.random.default_rng(seed)
        size = args.image_size
        x = rng.normal(size=(args.batch_size, size, size, 3)).astype(
            np.float32)
        y = rng.integers(1, args.classes + 1, size=(args.batch_size,))
        what = (f"batch {args.batch_size}, {size} px, input seed {seed}")
    return (net, copy.deepcopy(net).to("cpu"), zoo_step(criterion, x, y),
            what)


def zoo_parity(model):
    """One f32 step of ``model`` on the card and on the CPU, the wrappers'
    counts zeroed before the card's step and read after."""
    on_card, on_cpu, step, what = zoo_parity_setup(model)
    fed = bn_fed_biases(on_cpu)
    _zero_counts()
    t0 = time.perf_counter()
    card = step(on_card, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    used = _read_counts()
    cpu = step(on_cpu, "cpu")
    t2 = time.perf_counter()
    del on_card, on_cpu
    _free()
    norm, entry, ok = parity_report(card, cpu, f"zoo parity {model}",
                                    ZOO_PARITY[model][2], what, fed=fed)
    return dict(norm=norm, entry=entry, ok=ok, card_s=t1 - t0,
                cpu_s=t2 - t1, launches=used)


def zoo_reading():
    """The zoo_training phase's readings and failed checks."""
    failed, runs, parity = [], {}, {}
    for model in ZOO_IMAGE_MODELS:
        r = runs[model] = zoo_image_run(model)
        if len(r["losses"]) != r["steps"] or not np.all(
                np.isfinite(r["losses"])):
            failed.append(f"{model}: losses not finite or missing: "
                          f"{r['losses']}")
        if any(r["launches"].values()):
            failed.append(f"{model}: launched a kernel of #1-#11: "
                          f"{r['launches']}")
    steps = PTB_ITERS * PTB_EPOCHS
    with deterministic() as nondet:
        ptb = {"eager": zoo_ptb_run(1), "graph": zoo_ptb_run(PTB_ITERS)}
    for label, r in ptb.items():
        if len(r["losses"]) != steps or not np.all(np.isfinite(r["losses"])):
            failed.append(f"ptb-lstm {label}: losses not finite or missing: "
                          f"{r['losses']}")
        if any(r["launches"].values()):
            failed.append(f"ptb-lstm {label}: launched a kernel of #1-#11: "
                          f"{r['launches']}")
    dispatch = ptb["graph"]["opt"].dispatch_stats
    if dispatch != {"single_steps": 0, "window_steps": steps,
                    "captures": 1, "replays": steps}:
        failed.append(f"ptb-lstm: the windowed run dispatched {dispatch}")
    same_losses = ptb["eager"]["opt"].loss_history == \
        ptb["graph"]["opt"].loss_history
    same_params = all(torch.equal(p, q) for p, q in zip(
        ptb["eager"]["model"].parameters(), ptb["graph"]["model"].parameters()))
    if not (same_losses and same_params):
        failed.append(f"ptb-lstm: the graph run is not the eager run (losses "
                      f"{'equal' if same_losses else 'differ'}, parameters "
                      f"{'equal' if same_params else 'differ'})")
    for r in ptb.values():
        del r["opt"], r["model"]
    _free()
    for model in (*ZOO_IMAGE_MODELS, "ptb-lstm"):
        r = parity[model] = zoo_parity(model)
        if not r["ok"]:
            failed.append(f"{model}: the f32 step on the card differs "
                          f"from the CPU's beyond the stated bounds")
        if any(r["launches"].values()):
            failed.append(f"{model}: the f32 step launched a kernel of "
                          f"#1-#11: {r['launches']}")
    return dict(runs=runs, ptb=ptb, parity=parity, same_losses=same_losses,
                same_params=same_params, dispatch=dispatch,
                nondeterministic=sorted(nondet), failed=failed)


def phase_zoo(smi):
    """Inception-v1, Inception-v2 and VGG-16 trained in bf16 at b128, 224
    px; the PTB LSTM LM eagerly and in graph windows, bit for bit; one f32
    step of each against a CPU copy; no kernel of #1-#11 on any of them."""
    def report(r):
        for model, x in r["runs"].items():
            out = x["out"]
            print(f"zoo_training: {model}: {json.dumps(out)}")
            print(f"zoo_training: {model}: {x['steps']} bf16 steps at "
                  f"b{RESNET_BATCH} {RESNET_SIZE} px in {x['wall']:.3f} s; "
                  f"{out['records_per_sec']} images/s, "
                  f"{out['ms_per_iteration']} ms/iteration (steady windows); "
                  f"losses {[round(v, 6) for v in x['losses']]}; peak "
                  f"memory {x['peak']} bytes; launches of #1-#11 "
                  f"{sum(x['launches'].values())}")
            print(_busy_text(f"zoo_training: {model}", x["busy"],
                             out["ms_per_iteration"]))
        for label, x in r["ptb"].items():
            out = x["out"]
            tokens_s = PTB_BATCH * PTB_SEQ / (out["ms_per_iteration"] / 1e3)
            print(f"zoo_training: ptb-lstm {label}: {json.dumps(out)}")
            print(f"zoo_training: ptb-lstm {label}: "
                  f"{out['ms_per_iteration']} ms/iteration, {tokens_s:.1f} "
                  f"tokens/s; loss {x['losses'][0]:.6f} -> "
                  f"{x['losses'][-1]:.6f}; peak memory {x['peak']} bytes; "
                  f"launches of #1-#11 {sum(x['launches'].values())}")
            print(_busy_text(f"zoo_training: ptb-lstm {label}", x["busy"],
                             out["ms_per_iteration"]))
        print(f"zoo_training: ptb-lstm graph windows against eager: losses "
              f"{'equal' if r['same_losses'] else 'DIFFER'}, parameters "
              f"{'equal' if r['same_params'] else 'DIFFER'} bit for bit; "
              f"dispatch {r['dispatch']}; operations without a "
              f"deterministic implementation: "
              f"{r['nondeterministic'] or 'none'}")
        for model, x in r["parity"].items():
            print(f"zoo_training: parity {model}: card {x['card_s']:.2f} s, "
                  f"cpu {x['cpu_s']:.2f} s (TF32 off)")
        print(f"zoo_training: on {smi}")
    return _phase("zoo_training", zoo_reading, report)


# ---------------------------------------------------------------------------
# 13g. detection: SSD-300 VGG16 and Mask R-CNN inference
# ---------------------------------------------------------------------------

# A row of two runs may part only where a decision lay within rounding of
# a threshold or of a neighbour: a score within DET_SCORE_MARGIN of a
# threshold, a cut or another overlapping box's score, an IoU within
# DET_IOU_MARGIN of the NMS threshold (detections_held).
DET_SCORE_MARGIN = 1e-5
DET_IOU_MARGIN = 1e-5


def _np_box_iou(a, b):
    """The reference's box_iou (bigdl_tpu/nn/detection.py:66) in numpy,
    float32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) \
        * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) \
        * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, np.float32(0))


def nms_reference(boxes, scores, iou_threshold, max_output, pre_topk=None):
    """A copy of the reference's nms (bigdl_tpu/nn/detection.py:138-176)
    in numpy on the host, one row: its IoU in float32, a stable
    descending order (ties to the lower index), the greedy loop over
    every position, the compaction.  → (indices, valid)."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    n = boxes.shape[0]
    if pre_topk is not None and pre_topk < n:
        top_i = np.argsort(-scores, kind="stable")[:pre_topk]
        sub_idx, sub_valid = nms_reference(boxes[top_i], scores[top_i],
                                           iou_threshold, max_output)
        return top_i[sub_idx], sub_valid
    order = np.argsort(-scores, kind="stable")
    iou = _np_box_iou(boxes[order], boxes[order])
    keep = scores[order] > -np.inf
    pos = np.arange(n)
    for i in range(n):
        keep = keep & ~((iou[i] > iou_threshold) & (pos > i) & keep[i])
    perm = np.argsort(~keep, kind="stable")
    perm = perm[:max_output] if n >= max_output \
        else np.pad(perm, (0, max_output - n))
    valid = keep[perm] & (np.arange(max_output) < n)
    return np.where(valid, order[perm], 0), valid


def ssd_rows_reference(boxes, conf, det):
    """DetectionOutputSSD's rows of one image from its decoded ``boxes
    (P, 4)`` and ``conf (P, C)``, by the reference's _one_image
    (detection.py:879-908) over nms_reference, in numpy."""
    boxes = np.asarray(boxes, np.float32)
    conf = np.asarray(conf, np.float32)
    n_priors = boxes.shape[0]
    per_cls = min(det.nms_topk, n_priors)
    scores, bxs, lbls = [], [], []
    for c in range(det.n_classes):
        if c == det.bg_label:
            continue
        sc = np.where(conf[:, c] > det.conf_thresh, conf[:, c],
                      np.float32(-np.inf))
        keep, valid = nms_reference(boxes, sc, det.nms_thresh, per_cls,
                                    pre_topk=det.nms_topk)
        bxs.append(np.where(valid[:, None], boxes[keep], 0))
        scores.append(np.where(valid, conf[keep, c], -np.inf))
        lbls.append(np.full(per_cls, c))
    scores, bxs, lbls = (np.concatenate(a) for a in (scores, bxs, lbls))
    k = min(det.keep_top_k, scores.shape[0])
    idx = np.argsort(-scores, kind="stable")[:k]
    top = scores[idx]
    valid = top > -np.inf
    row = np.concatenate([np.where(valid, lbls[idx], 0)[:, None],
                          np.where(valid, top, 0)[:, None],
                          np.where(valid[:, None], bxs[idx], 0)], 1)
    return np.pad(row, ((0, det.keep_top_k - k), (0, 0))).astype(np.float32)


def planted_ssd_case(device="cuda"):
    """tests/test_detection.py's planted SSD case
    (test_ssd_detection_output_map): four priors, zero loc, class 1 on
    prior 0 and class 2 on prior 2 → (loc, conf, prior tensors on
    ``device``, the DetectionOutputSSD, the ground truths)."""
    from bigdl_tpu_torch.nn import DetectionOutputSSD
    priors = np.array([[0.05, 0.05, 0.2, 0.2], [0.3, 0.3, 0.5, 0.5],
                       [0.6, 0.6, 0.8, 0.8], [0.1, 0.6, 0.3, 0.9]],
                      np.float32)
    prior = np.stack([priors.reshape(-1),
                      np.full_like(priors, 0.1).reshape(-1)])
    conf = np.full((4, 3), 0.01, np.float32)
    conf[0, 1] = 0.95
    conf[2, 2] = 0.9
    det = DetectionOutputSSD(n_classes=3, keep_top_k=8, nms_topk=4,
                             conf_thresh=0.5)
    return (torch.zeros(1, 16, device=device),
            torch.as_tensor(conf.reshape(1, -1), device=device),
            torch.as_tensor(prior, device=device), det,
            [(np.array([1, 2]), priors[[0, 2]])])


def detections_held(got, want, nms_thresh, thresholds=(), box_tol=1e-5,
                    score_margin=DET_SCORE_MARGIN,
                    iou_margin=DET_IOU_MARGIN):
    """Hold two runs' detections, each ``(labels, scores, boxes)`` of its
    valid rows, and return (the rows each run has and the other lacks
    whose decision lay within rounding: near-tie rows, the rows without
    such a reason, the matched pairs), each row as (0 for got or 1 for
    want, its index).  Rows match by label, score (within score_margin)
    and box (within box_tol of the largest coordinate), and the matched
    pairs come back as the third item (indices into got's and want's
    rows).  A row one run
    lacks is a near-tie where its score lies within score_margin of a
    threshold in ``thresholds`` (a confidence threshold, a top-k cut) or
    of the other run's last score when that run is full, where its IoU
    with a row of its label lies within iou_margin of ``nms_thresh``,
    where a row of its label that it overlaps has a score within
    score_margin of its own (the order of the two decided which was
    kept), or where it overlaps another near-tie row of its label (it was
    suppressed by, or freed from, that row)."""
    sides = [tuple(np.asarray(a, np.float64) for a in side)
             for side in (got, want)]
    scale = max([1.0] + [float(np.abs(b).max()) for _, _, b in sides
                         if b.size])
    full = [len(l) == max(len(sides[0][0]), len(sides[1][0]))
            for l, _, _ in sides]
    used = [np.zeros(len(side[0]), bool) for side in sides]
    pairs = []
    lg, sg, bg = sides[0]
    for i, (l, sc, b) in enumerate(zip(*sides[1])):
        ok = ((lg == l) & (np.abs(sg - sc) <= score_margin)
              & (np.abs(bg - b).max(axis=1, initial=0) <= box_tol * scale)
              & ~used[0])
        if ok.any():
            pairs.append((int(np.argmax(ok)), i))
            used[0][pairs[-1][0]] = True
            used[1][i] = True
    rows = [(s, i) for s in (0, 1) for i in np.flatnonzero(~used[s])]
    both = [(t, j, side[0][j], side[1][j], side[2][j])
            for t, side in enumerate(sides) for j in range(len(side[0]))]

    def iou(a, b):
        return float(_np_box_iou(a[None].astype(np.float32),
                                 b[None].astype(np.float32))[0, 0])
    near = set()
    for s, i in rows:
        l, sc, b = (a[i] for a in sides[s])
        other = sides[1 - s]
        reasons = (
            any(abs(sc - t) <= score_margin for t in thresholds)
            or (full[1 - s] and len(other[1])
                and sc <= other[1].min() + score_margin)
            or any(lo == l and (t, j) != (s, i) and (
                abs(iou(b, bo) - nms_thresh) <= iou_margin
                or (abs(sc - so) <= score_margin
                    and iou(b, bo) > nms_thresh - iou_margin))
                for t, j, lo, so, bo in both))
        if reasons:
            near.add((s, i))
    grew = True
    while grew:
        grew = False
        for s, i in rows:
            if (s, i) in near:
                continue
            l, b = sides[s][0][i], sides[s][2][i]
            if any(sides[t][0][j] == l and iou(b, sides[t][2][j])
                   > nms_thresh - iou_margin for t, j in near):
                near.add((s, i))
                grew = True
    return ([r for r in rows if r in near],
            [r for r in rows if r not in near], pairs)


# SSD-300 at BASELINE config #5's width (bigdl_tpu/models/ssd.py:53-55
# defaults: 21 VOC classes, nms 0.45, top 400, keep 200, conf 0.01), f32,
# through the Predictor at batch 32 over SSD_IMAGES images and one-shot
# serving (SSD_REQUESTS single images, max_batch 32)
SSD_CLASSES, SSD_BATCH, SSD_IMAGES, SSD_REQUESTS = 21, 32, 128, 64
SSD_CPU_IMAGES = 4          # images of a batch whose heads a CPU copy redoes
# Mask R-CNN at MaskRCNNParams' defaults (maskrcnn.py:29-50) and 81 COCO
# classes on one 4:3 COCO image resized to a short side of 800 and padded
# to a multiple of 32: (height, width, original height, original width)
MASKRCNN_CLASSES, MASKRCNN_INFO = 81, (800.0, 1088.0, 600.0, 800.0)
# each bottleneck's last BatchNorm scale, times U(0.5, 1.5): at 1 the 16
# residual branches amplify rounding until f32 and f64 backbones part by
# 9e-5 in norm (and inputs moved by 2^-23 as far); at 0.2 by 3.5e-6
BN3_SCALE = 0.2
# card against the CPU copy fed the card's previous stage, TF32 off: the
# relative error in norm of each stage's tensors (loc, conf, the FPN maps,
# pooled features, logits, masks); f32 sums in another order differ by
# about 1e-6
DET_FEATURE_REL = 1e-4
DET_CONV_REL = 1e-4         # a convolution against its plain definition


def _rel_err(got, want) -> float:
    got = torch.as_tensor(got).detach().double().cpu()
    want = torch.as_tensor(want).detach().double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def he_scaled(model):
    """Every convolution's weight times sqrt(6): from the default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) to He's variance 2 / fan_in, so
    that activations keep their scale through the depth (as phase 13f
    conditions VGG-16); at the default the 23 convolutions shrink SSD's
    class logits until every score lies within rounding of the next."""
    from bigdl_tpu_torch.nn import (SpatialConvolution,
                                    SpatialDilatedConvolution)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (SpatialConvolution,
                              SpatialDilatedConvolution)):
                m.weight.mul_(6 ** 0.5)
    return model


def ssd_model(device="cuda"):
    from bigdl_tpu_torch.models import ssd_vgg16_300
    return he_scaled(ssd_vgg16_300(
        SSD_CLASSES, generator=torch.Generator().manual_seed(3),
        device=device)).eval()


def maskrcnn_model(image, device="cuda"):
    """Mask R-CNN conditioned on ``image`` (1, H, W, 3) so that its
    scores spread (at the inits they crowd within rounding of each
    other): every BatchNorm's scale drawn from U(0.5, 1.5), each
    block's last one's times BN3_SCALE (the init's zero scale there
    leaves the residual branches out), then its statistics set to the
    image's own (one
    train-mode forward of the backbone at momentum 1), the FPN's
    convolutions at He's variance (he_scaled), and the box head's score
    and delta weights scaled by 10."""
    from bigdl_tpu_torch.models import MaskRCNN
    from bigdl_tpu_torch.nn import BatchNormalization
    model = MaskRCNN(num_classes=MASKRCNN_CLASSES,
                     generator=torch.Generator().manual_seed(4),
                     device=device)
    gen = torch.Generator().manual_seed(6)
    he_scaled(model.backbone.fpn)
    norms = [m for m in model.modules() if isinstance(m, BatchNormalization)]
    with torch.no_grad():
        for name, bn in model.named_modules():
            if isinstance(bn, BatchNormalization):
                bn.weight.copy_((torch.rand(bn.weight.shape, generator=gen)
                                 + 0.5) * (BN3_SCALE if name.endswith(
                                     "bn3") else 1.0))
                bn.momentum = 1.0
        model.backbone.train()(torch.as_tensor(image, device=device))
        for bn in norms:
            bn.momentum = 0.1
        model.box_head.cls_score.weight.mul_(10.0)
        model.box_head.bbox_pred.weight.mul_(10.0)
    return model.eval()


def dilated_reference(conv, x):
    """A dilated convolution by its definition: the kernel with d - 1
    zeros between taps, then a plain convolution (NHWC in and out)."""
    import torch.nn.functional as F
    (dh, dw), w = conv.dilation, conv.weight
    kh, kw = w.shape[:2]
    wz = w.new_zeros(((kh - 1) * dh + 1, (kw - 1) * dw + 1, *w.shape[2:]))
    wz[::dh, ::dw] = w
    y = F.conv2d(x.permute(0, 3, 1, 2), wz.permute(3, 2, 0, 1), conv.bias,
                 stride=conv.stride, padding=conv.pad)
    return y.permute(0, 2, 3, 1)


def full_reference(conv, x):
    """A transposed convolution by the reference's definition
    (bigdl_tpu/nn/conv.py:197-213): the input with stride - 1 zeros
    between pixels, padded k - 1 - p and k - 1 - p + adj, convolved with
    the spatially flipped kernel, grouped."""
    import torch.nn.functional as F
    (sh, sw), (ph, pw), (ah, aw) = conv.stride, conv.pad, conv.adj
    kh, kw = conv.kernel
    b, h, w, c = x.shape
    d = x.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
    d[:, :, ::sh, ::sw] = x.permute(0, 3, 1, 2)
    d = F.pad(d, (kw - 1 - pw, kw - 1 - pw + aw, kh - 1 - ph,
                  kh - 1 - ph + ah))
    wf = torch.flip(conv.weight, (0, 1)).permute(3, 2, 0, 1)
    y = F.conv2d(d, wf, conv.bias, groups=conv.n_group)
    return y.permute(0, 2, 3, 1)


def planted_nms_rows(device="cuda"):
    """NMS rows with planted decisions: IoU exactly at the threshold
    (9/20 = float32(0.45): kept, IoU > t suppresses), scores from four
    values (ties everywhere, the pre-top-k cut among them), rows all at
    -inf, and fewer boxes than output slots → [(what, boxes, scores,
    threshold, max_output, pre_topk)], tensors on ``device``."""
    rng = np.random.default_rng(31)

    def boxes_of(r, n, size, extent, lo):
        b = (rng.random((r, n, 4)) * size).astype(np.float32)
        b[..., 2:] = b[..., :2] + rng.random((r, n, 2)).astype(
            np.float32) * extent + lo
        return b
    s = 1.0 / 32
    pairs = sum(([[k, 0.5, k + 14 * s, 0.5 + s],
                  [k + 5 * s, 0.5, k + 20 * s, 0.5 + s]]
                 for k in range(4)), [])
    at = np.asarray([pairs] * 3, np.float32)
    at_scores = np.asarray([[0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2],
                            [0.5] * 8, [0.2, 0.9] * 4], np.float32)
    ties = np.floor(rng.random((20, 1200)) * 4).astype(np.float32) / 4
    neg = np.full((3, 50), -np.inf, np.float32)
    neg[1, :4] = rng.random(4)
    rows = [("iou_at_threshold", at, at_scores, 0.45, 8, None),
            ("tied_scores", boxes_of(20, 1200, 1.0, 0.3, 0.02), ties, 0.45,
             400, 400),
            ("all_neg_inf", boxes_of(3, 50, 80, 40, 5), neg, 0.5, 20, None),
            ("n_below_max_output", boxes_of(4, 9, 80, 40, 5),
             rng.random((4, 9)).astype(np.float32), 0.5, 16, None)]
    return [(what, torch.as_tensor(b, device=device),
             torch.as_tensor(sc, device=device), t, m, pre)
            for what, b, sc, t, m, pre in rows]


def planted_ssd_ties(device="cuda"):
    """DetectionOutputSSD at SSD-300's width (8,732 priors, 21 classes)
    over two images whose class scores take five values: ties at the
    conf threshold, in each class's top-400 cut and in the final top 200
    → (boxes (2, 8732, 4), conf (2, 8732 * 21) on ``device``)."""
    rng = np.random.default_rng(32)
    p = 8732
    boxes = (rng.random((2, p, 4)) * 0.8).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.random((2, p, 2)).astype(
        np.float32) * 0.2 + 0.01
    conf = np.floor(rng.random((2, p, SSD_CLASSES)) * 5).astype(
        np.float32) / 100 + np.float32(0.01)
    return (torch.as_tensor(boxes, device=device),
            torch.as_tensor(conf.reshape(2, -1), device=device))


def detection_gate(device="cuda") -> dict:
    """The detection phase's checks against independent definitions, on
    ``device``: planted NMS rows through the port's ``nms`` against the
    numpy copy of the reference's loop (nms_reference); SSD's
    DetectionOutputSSD.select over planted ties against the reference's
    per-image loop (ssd_rows_reference); fc6's dilated convolution and
    the mask head's transposed one (and a grouped, odd-kernel, adj 1
    one) at the path's shapes against their definitions; the planted-box
    case of tests/test_detection.py, whose VOC mAP must read 1.0.
    Returns the readings and the failed checks."""
    from bigdl_tpu_torch.nn import (DetectionOutputSSD,
                                    SpatialDilatedConvolution,
                                    SpatialFullConvolution, nms)
    from bigdl_tpu_torch.optim import MeanAveragePrecisionObjectDetection
    failed, r = [], {"nms_rows": {}}
    with torch.inference_mode():
        for what, boxes, scores, thresh, m, pre in planted_nms_rows(device):
            idx, valid = nms(boxes, scores, thresh, m, pre)
            idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
            b, sc = boxes.cpu().numpy(), scores.cpu().numpy()
            bad = [i for i in range(len(b))
                   if not all(np.array_equal(x, y) for x, y in zip(
                       (idx[i], valid[i]),
                       nms_reference(b[i], sc[i], thresh, m, pre)))]
            r["nms_rows"][what] = dict(rows=len(b), kept=int(valid.sum()),
                                       differ=len(bad))
            if bad:
                failed.append(f"nms on {what}: rows {bad} differ from the "
                              "reference's loop")
        det = DetectionOutputSSD(n_classes=SSD_CLASSES)
        boxes, conf = planted_ssd_ties(device)
        rows = det.select(boxes, conf).cpu().numpy()
        bx, cf = boxes.cpu().numpy(), conf.cpu().numpy()
        bad = [i for i in range(len(rows)) if not np.array_equal(
            rows[i], ssd_rows_reference(bx[i], cf[i].reshape(
                -1, SSD_CLASSES), det))]
        r["ssd_tied_images_differ"] = len(bad)
        if bad:
            failed.append(f"DetectionOutputSSD over tied scores: images "
                          f"{bad} differ from the reference's loop")
        gen = torch.Generator().manual_seed(33)
        convs = {
            "fc6_dilated": (SpatialDilatedConvolution(
                512, 1024, 3, 3, 1, 1, 6, 6, 6, 6, generator=gen,
                device=device), (4, 19, 19, 512), dilated_reference),
            "mask_deconv": (SpatialFullConvolution(
                256, 256, 2, 2, 2, 2, generator=gen, device=device),
                (100, 14, 14, 256), full_reference),
            "full_groups2_k3_adj1": (SpatialFullConvolution(
                64, 96, 3, 3, 2, 2, 1, 1, 1, 1, n_group=2, generator=gen,
                device=device), (8, 15, 13, 64), full_reference)}
        r["convs"] = {}
        for what, (conv, shape, reference) in convs.items():
            x = torch.randn(shape, generator=gen).to(device)
            err = _rel_err(conv(x), reference(conv, x))
            r["convs"][what] = err
            if not err <= DET_CONV_REL:
                failed.append(f"{what}: {err:.3e} from its definition in "
                              f"norm (bound {DET_CONV_REL})")
        loc, conf, prior, det, gts = planted_ssd_case(device)
        out = det((loc, conf, prior)).cpu().numpy()[0]
        kept = out[out[:, 1] > 0]
        r["planted_map"] = MeanAveragePrecisionObjectDetection(
            classes=2, iou_thresh=0.5).evaluate(
                [(kept[:, 0].astype(int), kept[:, 1], kept[:, 2:6])], gts)
        if r["planted_map"] != 1.0:
            failed.append(f"the planted boxes read mAP {r['planted_map']}, "
                          "not 1.0")
    r["failed"] = failed
    return r


def host_ops():
    """A TorchDispatchMode to enter around a forward: its ``ops`` lists
    each operator that read a device value to the host, copied to the
    host or computed on a host tensor of more than one element."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class HostOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            host = [a for a in tree_leaves((args, kwargs, out))
                    if isinstance(a, torch.Tensor)
                    and a.device.type == "cpu" and a.numel() > 1]
            if host or func is torch.ops.aten._local_scalar_dense.default:
                self.ops.append(str(func))
            return out
    return HostOps()


def stage_split(stages):
    """Run ``stages`` ([(name, fn)], each fn taking the previous stage's
    result) once under traced(), a marker kernel between stages: {name:
    (device busy ms, kernels launched)} from the trace, and the result."""
    def run():
        out = None
        for i, (_, fn) in enumerate(stages):
            if i:
                torch.cuda._sleep(1)
            out = fn(out)
        torch.cuda.synchronize()
        return out
    run()
    out, events = traced_call(run)
    split, i = {name: [0.0, 0] for name, _ in stages}, 0
    names = [name for name, _ in stages]
    for e in events:
        if MARKER in e.name:
            i += 1
            continue
        split[names[i]][0] += e.time_range.elapsed_us() / 1e3
        split[names[i]][1] += 1
    if i != len(stages) - 1:
        raise TraceLost(f"stage_split: {i} markers between "
                        f"{len(stages)} stages")
    return {k: tuple(v) for k, v in split.items()}, out


def _timed_ms(fn, runs=3):
    """Median ms of ``fn()`` between CUDA events, its work ending in a
    synchronize (host clock beside it)."""
    times, host = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.median(host))


def _held_rows(got, want, det, conf, what, failed):
    """detections_held over SSD rows ``got``/``want`` (K, 6) of one image,
    the cuts from ``conf`` (P, C); → near-tie rows."""
    def rows(x):
        kept = x[x[:, 1] > 0]
        return kept[:, 0], kept[:, 1], kept[:, 2:]
    cuts = [np.sort(conf[:, c])[::-1][min(det.nms_topk, len(conf)) - 1]
            for c in range(conf.shape[1]) if c != det.bg_label]
    near, unexplained, _ = detections_held(
        rows(got), rows(want), det.nms_thresh,
        thresholds=[det.conf_thresh, *cuts])
    if unexplained:
        failed.append(f"{what}: rows {unexplained} differ with no "
                      f"decision within rounding ({len(near)} near-tie)")
    return len(near)


def ssd_reading(device="cuda") -> dict:
    """SSD-300 through the Predictor (SSD_IMAGES images at batch 32) and
    one-shot serving (SSD_REQUESTS single images, max_batch 32): rates,
    the device split of a batch (VGG + heads, prior decode, NMS / top-k),
    the NMS launches, peak memory; a batch's heads against a CPU copy,
    its rows against the CPU path fed the card's loc and conf and against
    the reference's loop on the card's decoded boxes; each served row
    against the image's solo forward."""
    import copy
    from bigdl_tpu_torch.nn.detection import nms
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.serving import ModelServer
    failed, r = [], {}
    model = ssd_model(device)
    cpu = copy.deepcopy(model).to("cpu")
    images = np.random.default_rng(21).normal(
        size=(SSD_IMAGES, 300, 300, 3)).astype(np.float32)
    predictor = Predictor(model, batch_size=SSD_BATCH, device=device)
    predictor.predict(list(images[:SSD_BATCH]))       # priors, workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, steps = nms.launches, nms.steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    rows = np.stack(predictor.predict(list(images)))
    end.record()
    end.synchronize()
    r["predict_s"] = start.elapsed_time(end) / 1e3
    r["predict_host_s"] = time.perf_counter() - t0
    batches = SSD_IMAGES // SSD_BATCH
    r["images_per_s"] = SSD_IMAGES / r["predict_s"]
    r["nms_per_batch"] = ((nms.launches - launches) / batches,
                          (nms.steps - steps) / batches)
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if rows.shape != (SSD_IMAGES, 200, 6) or not np.isfinite(rows).all():
        failed.append(f"Predictor rows of shape {rows.shape}, finite "
                      f"{np.isfinite(rows).all()}")
    r["kept_per_image"] = float((rows[:, :, 1] > 0).sum(1).mean())
    m = predictor.model
    x = torch.as_tensor(images[:SSD_BATCH], device=device)
    with torch.inference_mode():
        busy = traced_call(lambda: predictor.predict(
            list(images[:SSD_BATCH])))[1]
        r["batch_busy_ms"] = sum(e.time_range.elapsed_us() for e in busy
                                 if MARKER not in e.name) / 1e3
        r["batch_ms"], r["batch_host_ms"] = _timed_ms(
            lambda: predictor.predict(list(images[:SSD_BATCH])))
        r["split"], (loc, conf, prior, boxes, card_rows) = stage_split([
            ("vgg_heads", lambda _: m.heads(x)),
            ("prior_decode", lambda h: (*h, m.detection.decode(h[0],
                                                               h[2]))),
            ("nms_topk", lambda h: (*h, m.detection.select(h[3], h[1])))])
        mode = host_ops()
        with mode:
            m(x)
        r["host_ops"] = mode.ops
        if mode.ops:
            failed.append(f"the forward touched the host: {mode.ops[:8]}")
        # stage 1: the heads of SSD_CPU_IMAGES images on a CPU copy
        n = SSD_CPU_IMAGES
        cloc, cconf, cprior = cpu.heads(torch.as_tensor(images[:n]))
        r["loc_rel_err"] = _rel_err(loc[:n], cloc)
        r["conf_rel_err"] = _rel_err(conf[:n], cconf)
        if not max(r["loc_rel_err"], r["conf_rel_err"]) <= DET_FEATURE_REL:
            failed.append(f"SSD heads off the CPU copy's: loc "
                          f"{r['loc_rel_err']:.3e}, conf "
                          f"{r['conf_rel_err']:.3e} in norm")
        if not torch.equal(prior.cpu(), cprior):
            failed.append("SSD priors differ from the CPU copy's")
        # stages 2-3: the CPU path fed the card's loc and conf, and the
        # reference's loop on the card's decoded boxes
        lc, cc, pc = loc.cpu(), conf.cpu(), prior.cpu()
        cpu_rows = cpu.detection((lc, cc, pc)).numpy()
        card_rows = card_rows.cpu().numpy()
        bx = boxes.cpu().numpy()
        cf = cc.numpy().reshape(SSD_BATCH, -1, SSD_CLASSES)
        r["cpu_near_tie_rows"] = sum(
            _held_rows(card_rows[i], cpu_rows[i], m.detection, cf[i],
                       f"image {i}: card against CPU", failed)
            for i in range(SSD_BATCH))
        bad = [i for i in range(SSD_BATCH) if not np.array_equal(
            card_rows[i], ssd_rows_reference(bx[i], cf[i], m.detection))]
        r["reference_images_differ"] = len(bad)
        if bad:
            failed.append(f"SSD rows of images {bad} differ from the "
                          "reference's loop on the card's boxes")
    # one-shot serving: single-image requests coalesced to max_batch 32
    server = ModelServer(model, max_batch=SSD_BATCH, batch_timeout_ms=20.0,
                         device=device)
    try:
        server.warmup(images[0])
        t0 = time.perf_counter()
        served = server.submit_many(list(images[:SSD_REQUESTS]), timeout=600)
        r["serve_s"] = time.perf_counter() - t0
        r["serve_metrics"] = server.metrics.snapshot()
    finally:
        server.shutdown()
    r["serve_near_tie_rows"] = 0
    with torch.inference_mode():
        for i in range(SSD_REQUESTS):
            loc1, conf1, prior1 = m.heads(torch.as_tensor(
                images[i:i + 1], device=device))
            solo = m.detection((loc1, conf1, prior1)).cpu().numpy()[0]
            r["serve_near_tie_rows"] += _held_rows(
                np.asarray(served[i]), solo, m.detection,
                conf1.cpu().numpy().reshape(-1, SSD_CLASSES),
                f"served request {i} against its solo forward", failed)
    r["failed"] = failed
    return r


def maskrcnn_reading(device="cuda") -> dict:
    """Mask R-CNN on one 800 x 1088 image: ms per image, the device split
    by stage, the NMS launches, peak memory; each stage against the CPU
    copy fed the card's previous stage."""
    import copy
    from bigdl_tpu_torch.nn.detection import nms
    failed, r = [], {}
    h, w = int(MASKRCNN_INFO[0]), int(MASKRCNN_INFO[1])
    image = np.random.default_rng(22).normal(size=(1, h, w, 3)).astype(
        np.float32)
    model = maskrcnn_model(image, device)
    cpu = copy.deepcopy(model).to("cpu")
    x = torch.as_tensor(image, device=device)
    info = torch.as_tensor(MASKRCNN_INFO, device=device)
    hw = info[:2]
    rpn, bh, mh = model.rpn, model.box_head, model.mask_head
    with torch.inference_mode():
        model((x, info))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches, steps = nms.launches, nms.steps
        outs = model((x, info))
        torch.cuda.synchronize()
        r["nms_per_image"] = (nms.launches - launches, nms.steps - steps)
        r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        r["image_ms"], r["image_host_ms"] = _timed_ms(
            lambda: model((x, info)))
        mode = host_ops()
        with mode:
            model((x, info))
        r["host_ops"] = mode.ops
        if mode.ops:
            failed.append(f"the forward touched the host: {mode.ops[:8]}")
        s = {}

        def keep(name, fn):
            def run(prev):
                s[name] = fn(prev)
                return s[name]
            return name, run
        r["split"], _ = stage_split([
            keep("backbone_fpn", lambda _: model.backbone(x)),
            keep("rpn_head", lambda f: rpn.level_outputs(f)),
            keep("rpn_nms", lambda o: rpn.propose(o, hw)),
            keep("box_pooler", lambda p: bh.pooler(
                (s["backbone_fpn"], p[0]))),
            keep("box_predict", lambda pooled: bh.predict(pooled)),
            keep("box_nms", lambda lg: bh.select(
                *lg, s["rpn_nms"][0], hw, s["rpn_nms"][1] > float("-inf"))),
            keep("mask_pooler", lambda d: mh.pooler(
                (s["backbone_fpn"], d[0]))),
            keep("mask_head", lambda pooled: mh.masks_of(
                pooled, s["box_nms"][1])[0])])
        masks = torch.where(s["box_nms"][3][:, None, None], s["mask_head"],
                            0.0)
        staged = (*s["box_nms"], masks)
        if not all(torch.equal(a, b) for a, b in zip(staged, outs)):
            failed.append("the staged forward differs from the model's")
        boxes, labels, scores, valid, _ = (o.cpu().numpy() for o in outs)
        r["detections"] = int(valid.sum())
        if not all(np.isfinite(o.cpu().numpy()).all() for o in outs):
            failed.append("Mask R-CNN's outputs are not finite")

        def host(v):
            if isinstance(v, (tuple, list)):
                return type(v)(host(a) for a in v)
            return v.cpu()
        # each stage on the CPU copy, fed the card's previous stage
        errs = {}
        feats = cpu.backbone(host(x))
        errs["fpn"] = max(_rel_err(a, b) for a, b in
                          zip(s["backbone_fpn"], feats))
        cf = host(s["backbone_fpn"])
        errs["rpn_head"] = max(_rel_err(a, b) for pair in zip(
            s["rpn_head"], cpu.rpn.level_outputs(cf)) for a, b in zip(*pair))
        prop_c = cpu.rpn.propose(host(s["rpn_head"]), host(hw))
        def props(boxes, scores):
            ok = np.isfinite(scores)
            return np.ones(int(ok.sum())), scores[ok], boxes[ok]
        near_p, un_p, _ = detections_held(
            props(*(v.cpu().numpy() for v in s["rpn_nms"])),
            props(*(v.numpy() for v in prop_c)), rpn.nms_thresh)
        if un_p:
            failed.append(f"RPN proposals {un_p} differ from the CPU's "
                          "with no decision within rounding")
        errs["box_pooler"] = _rel_err(s["box_pooler"], cpu.box_head.pooler(
            (cf, host(s["rpn_nms"][0]))))
        errs["box_predict"] = max(_rel_err(a, b) for a, b in zip(
            s["box_predict"], cpu.box_head.predict(host(s["box_pooler"]))))
        sel_c = cpu.box_head.select(
            *host(s["box_predict"]), host(s["rpn_nms"][0]), host(hw),
            host(s["rpn_nms"][1]) > float("-inf"))

        def dets(v):
            b, l, sc, ok = (a.cpu().numpy() for a in v)
            return l[ok], sc[ok], b[ok]
        near_b, un_b, _ = detections_held(
            dets(s["box_nms"]), dets(sel_c), bh.nms_thresh,
            thresholds=[bh.score_thresh])
        if un_b:
            failed.append(f"box head detections {un_b} differ from the "
                          "CPU's with no decision within rounding")
        errs["mask_pooler"] = _rel_err(s["mask_pooler"], cpu.mask_head.pooler(
            (cf, host(s["box_nms"][0]))))
        errs["mask_head"] = _rel_err(s["mask_head"], cpu.mask_head.masks_of(
            host(s["mask_pooler"]), host(s["box_nms"][1]))[0])
        r["stage_rel_err"] = errs
        r["near_tie_rows"] = {"rpn": len(near_p), "box_head": len(near_b)}
        for what, err in errs.items():
            if not err <= DET_FEATURE_REL:
                failed.append(f"{what}: {err:.3e} from the CPU copy's in "
                              f"norm (bound {DET_FEATURE_REL})")
    r["failed"] = failed
    return r


def detection_reading(device="cuda") -> dict:
    """The detection phase's readings and failed checks: TF32 set off and
    checked, the gate, SSD, Mask R-CNN, and no launch of #1-#11."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        failed.append("TF32 is on")
    _zero_counts()
    t0 = time.perf_counter()
    gate = detection_gate(device)
    ssd = ssd_reading(device)
    maskrcnn = maskrcnn_reading(device)
    launches = _read_counts()
    if any(launches.values()):
        failed.append(f"a kernel of #1-#11 launched: {launches}")
    return dict(gate=gate, ssd=ssd, maskrcnn=maskrcnn, launches=launches,
                seconds=time.perf_counter() - t0,
                failed=failed + [f"gate: {f}" for f in gate["failed"]]
                + [f"ssd: {f}" for f in ssd["failed"]]
                + [f"maskrcnn: {f}" for f in maskrcnn["failed"]])


def phase_detection(smi, device="cuda"):
    """13g: SSD-300 and Mask R-CNN inference; see detection_reading."""
    def report(r):
        g, s, m = r["gate"], r["ssd"], r["maskrcnn"]
        print(f"detection: gate: nms rows {g['nms_rows']}; SSD over tied "
              f"scores {g['ssd_tied_images_differ']} images differ; convs "
              f"against their definitions "
              f"{ {k: f'{v:.3e}' for k, v in g['convs'].items()} }; planted "
              f"mAP {g['planted_map']}", flush=True)
        sp = s["split"]
        total = sum(v[0] for v in sp.values())
        print(f"detection: SSD-300 VGG16 f32, {SSD_CLASSES} classes, "
              f"Predictor(batch_size={SSD_BATCH}) over {SSD_IMAGES} images: "
              f"{s['images_per_s']:.2f} images/s ({s['predict_s']:.4f} s "
              f"CUDA events, {s['predict_host_s']:.4f} s host clock, ending "
              f"in the readback); a batch {s['batch_ms']:.3f} ms ("
              f"{s['batch_ms'] / SSD_BATCH:.3f} ms per image), device busy "
              f"{s['batch_busy_ms']:.3f} ms, idle share "
              f"{1 - s['batch_busy_ms'] / s['batch_ms']:.3f}; device split "
              f"of a batch: VGG + heads {sp['vgg_heads'][0]:.3f} ms in "
              f"{sp['vgg_heads'][1]} kernels, prior decode "
              f"{sp['prior_decode'][0]:.3f} ms in {sp['prior_decode'][1]}, "
              f"NMS / top-k {sp['nms_topk'][0]:.3f} ms in "
              f"{sp['nms_topk'][1]} (NMS share {sp['nms_topk'][0] / total:.3f}"
              f"); nms calls and loop steps per batch {s['nms_per_batch']}; "
              f"{s['kept_per_image']:.1f} rows kept per image; peak memory "
              f"{s['peak_memory_bytes']} bytes; on {smi}", flush=True)
        print(f"detection: SSD card against CPU: loc "
              f"{s['loc_rel_err']:.3e}, conf {s['conf_rel_err']:.3e} in norm "
              f"({SSD_CPU_IMAGES} images); rows from the card's loc and conf: "
              f"{s['cpu_near_tie_rows']} near-tie rows over {SSD_BATCH} "
              f"images, {s['reference_images_differ']} images off the "
              f"reference's loop; host ops in a forward "
              f"{len(s['host_ops'])}", flush=True)
        sm = s["serve_metrics"]
        print(f"detection: SSD served: {SSD_REQUESTS} single images in "
              f"{s['serve_s']:.4f} s = {SSD_REQUESTS / s['serve_s']:.2f} "
              f"requests/s, {sm['batches']} batches, latency p50 "
              f"{sm['latency_ms']['p50']:.3f} ms, p99 "
              f"{sm['latency_ms']['p99']:.3f} (host clock); "
              f"{s['serve_near_tie_rows']} near-tie rows against solo "
              f"forwards; on {smi}", flush=True)
        sp = m["split"]
        total = sum(v[0] for v in sp.values())

        def part(*names):
            return (sum(sp[n][0] for n in names), sum(sp[n][1] for n in names))
        groups = {"backbone + FPN": part("backbone_fpn"),
                  "RPN + its NMS": part("rpn_head", "rpn_nms"),
                  "Pooler / RoiAlign": part("box_pooler", "mask_pooler"),
                  "box head + its NMS": part("box_predict", "box_nms"),
                  "mask head": part("mask_head")}
        nms_ms = sp["rpn_nms"][0] + sp["box_nms"][0]
        print(f"detection: Mask R-CNN f32, {MASKRCNN_CLASSES} classes, "
              f"800 x 1088: {m['image_ms']:.3f} ms per image (CUDA events; "
              f"{m['image_host_ms']:.3f} host clock); device split "
              + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]} kernels"
                          for k, v in groups.items())
              + f"; NMS / top-k share {nms_ms / total:.3f}; nms calls and "
              f"loop steps per image {m['nms_per_image']}; "
              f"{m['detections']} detections; peak memory "
              f"{m['peak_memory_bytes']} bytes; on {smi}", flush=True)
        print(f"detection: Mask R-CNN stages against the CPU copy fed the "
              f"card's previous stage: "
              f"{ {k: f'{v:.3e}' for k, v in m['stage_rel_err'].items()} } "
              f"in norm; near-tie rows {m['near_tie_rows']}; host ops in a "
              f"forward {len(m['host_ops'])}", flush=True)
        print(f"detection: launches of #1-#11 {sum(r['launches'].values())}; "
              f"TF32 off; {r['seconds']:.1f} s; on {smi}", flush=True)
    return _phase("detection", lambda: detection_reading(device), report)


# ---------------------------------------------------------------------------
# 13h. methods: every optim method and schedule, Adam on the LM, the
# ImageNet recipe on ResNet-50, and the NCF and autoencoder recipes
# ---------------------------------------------------------------------------

# LeNet-5 (b256, f32) over METHOD_BATCHES distinct batches: eager, and in
# windows of METHOD_WINDOW (two windows and a ragged tail of single steps)
METHOD_BATCHES, METHOD_WINDOW = 10, 4
# card (eager) against a CPU copy fed the same batches, TF32 off: each
# loss within METHOD_LOSS_RTOL, each parameter within METHOD_PARAM_NORM_REL
# in norm.  NORMALISED_METHODS divide each entry's step by its own
# gradient history, with steps that do not shrink with the gradient
# (RMSprop's first moves every entry by 10 lr): over 10 steps they
# amplify any change of summation order, the CPU's own too.  Measured on
# an H100 80GB HBM3 (700 W) with an 8-core host: RMSprop's card and CPU
# 2.385e-03 apart in norm, and the CPU at 1 thread and at 8 threads
# 2.385e-03 apart as well (Adagrad 4.070e-05 and 4.069e-05), while
# their first gradients agree in sign everywhere (lenet_grad_signs).  So they are held to NORMALISED_NORM_REL, and their
# CPU spread (cpu_spread: 1 thread against the default) is printed
# beside their card reading
METHOD_LOSS_RTOL, METHOD_PARAM_NORM_REL = 1e-4, 1e-3
NORMALISED_METHODS, NORMALISED_NORM_REL = ("Adagrad", "Adadelta", "Adamax",
                                           "RMSprop"), 1e-2
# the schedules run 3 epochs of 4 batches in windows of 4 (every step a
# replay); Plateau 16 iterations in windows of 2, a validation every 2
# iterations scoring PLATEAU_SCORES (two reductions and a cooldown)
SCHEDULE_BATCHES, SCHEDULE_EPOCHS = 4, 3
PLATEAU_EVERY, PLATEAU_STEPS = 2, 16
PLATEAU_SCORES = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95]
# the LM with Adam: phase 6's width, 2 epochs of 4 steps, eagerly and in
# windows of 4 (two replayed windows)
ADAM_ITERS, ADAM_EPOCHS, ADAM_TIMED = 4, 2, 10
ADAM_ARGV = TRAIN_ARGV[:-4] + ["--iterations", str(ADAM_ITERS),
                               "--epochs", str(ADAM_EPOCHS)]
# ResNet-50 with the ImageNet recipe (bigdl_tpu/examples/imagenet.py:
# 284-302): SGD, momentum 0.9, nesterov, weight decay 1e-4, a linear
# warm-up over its first epoch to the peak, then Poly(0.5) over the rest
IMAGENET_PEAK_LR, IMAGENET_WARM_EPOCHS = 0.1, 1
# NCF at MovieLens-1M's widths; the autoencoder as its example runs
NCF_USERS, NCF_ITEMS, NCF_PER_USER = 6040, 3706, 8
NCF_ARGV = ["-b", "256", "-e", "2", "--embed-dim", "16", "-r", "0.001",
            "-q"]
AUTOENCODER_ARGV = ["--synthetic", "6000", "-b", "150", "-e", "2", "-q"]


def method_cases():
    """{name: a fresh method}: every method of optim/methods.py."""
    from bigdl_tpu_torch.optim import methods as m
    return {
        "SGD": lambda: m.SGD(0.05, momentum=0.9, dampening=0.0,
                             weight_decay=1e-4, nesterov=True),
        "Adam": lambda: m.Adam(1e-3),
        "ParallelAdam": lambda: m.ParallelAdam(2e-3, weight_decay=1e-4),
        "Adagrad": lambda: m.Adagrad(0.01, weight_decay=5e-4),
        "Adadelta": lambda: m.Adadelta(0.9, 1e-6),
        "Adamax": lambda: m.Adamax(0.002),
        "RMSprop": lambda: m.RMSprop(1e-3, learning_rate_decay=0.01),
        "Ftrl": lambda: m.Ftrl(0.05, l1_regularization_strength=1e-4,
                               l2_regularization_strength=1e-4),
        "LarsSGD": lambda: m.LarsSGD(0.1, trust_coefficient=0.02),
        "LBFGS": lambda: m.LBFGS(n_correction=10, learning_rate=0.05),
    }


def schedule_cases():
    """{name: a fresh schedule}: every schedule of optim/methods.py but
    Plateau, which runs on its own (plateau_run)."""
    from bigdl_tpu_torch.optim import methods as m
    return {
        "Default": lambda: m.Default(0.1),
        "Step": lambda: m.Step(3, 0.7),
        "MultiStep": lambda: m.MultiStep([2, 5, 9], 0.3),
        "EpochStep": lambda: m.EpochStep(1, 0.5),
        "EpochDecay": lambda: m.EpochDecay(lambda e: e // 2),
        "Poly": lambda: m.Poly(0.5, 12),
        "Exponential": lambda: m.Exponential(4, 0.9),
        "NaturalExp": lambda: m.NaturalExp(3, 0.35),
        "Warmup": lambda: m.Warmup(0.005),
        "SequentialSchedule": lambda: m.SequentialSchedule(4)
        .add(m.Warmup(0.01), 5).add(m.Poly(0.5, 7), 7),
        "EpochSchedule": lambda: m.EpochSchedule([(1, 1, 0.05),
                                                  (2, 3, 0.02)]),
    }


def record_scalars(opt):
    """Read back, after every step of ``opt``, the step-scalar tensors that
    step read: the captured graph's after each replay, the eager set
    after each single step.  Returns the list they are appended to, one
    [[scalars of each group]] a step."""
    readings = []
    capture, single = opt._capture, opt._single_step

    def read(tensors):
        readings.append([[float(t) for t in ts] for ts in tensors])

    class Replayed:
        def __init__(self, step_graph):
            self.step_graph, self.graph = step_graph, step_graph.graph

        def replay(self):
            self.graph.replay()
            read(self.step_graph.scalars)

    def captured(*args):
        step_graph = capture(*args)
        step_graph.graph = Replayed(step_graph)
        return step_graph

    def stepped(*args):
        loss = single(*args)
        read(opt._scalars)
        return loss
    opt._capture, opt._single_step = captured, stepped
    return readings


class PlantedScore:
    """A validation method whose i-th validation (of one batch) scores
    ``scores[i]``: the planted metric a Plateau schedule is told."""

    fmt = "planted"

    def __init__(self, scores):
        self.scores = iter(scores)

    def batch_stats(self, output, target):
        return next(self.scores), 1.0

    def to_result(self, num, den):
        from bigdl_tpu_torch.optim.validation import ValidationResult
        return ValidationResult(num, den, self.fmt)


def lenet_setup():
    """LeNet-5 as perf.build makes it (seed 0) on the host, whence each
    run copies it, its criterion and METHOD_BATCHES distinct b256
    batches."""
    from bigdl_tpu_torch.examples import perf
    args = perf.parse_args(LENET_ARGV + ["--device", "cpu"])
    model, criterion, make_batch = perf.build("lenet", args)
    batches = [make_batch(args.batch_size) for _ in range(METHOD_BATCHES)]
    return model, criterion, batches


def lenet_method_run(model, criterion, batches, method, k, device,
                     epochs=1, configure=None):
    """``method`` on a copy of ``model`` over ``batches`` for ``epochs``
    on ``device`` in windows of ``k``: (model, optimizer, the step
    scalars each step read)."""
    import copy
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.optim import Optimizer, Trigger
    model = copy.deepcopy(model).to(device)
    data = DataSet.array([MiniBatch(x, y) for x, y in batches],
                         shuffle=False)
    if device != "cpu":
        data = data.cache_on_device(device)
    opt = (Optimizer(model, data, criterion, seed=0)
           .set_optim_method(method)
           .set_end_when(Trigger.max_epoch(epochs))
           .set_iterations_per_dispatch(k))
    if configure is not None:
        configure(opt)
    scalars = record_scalars(opt)
    opt.optimize()
    if device != "cpu":
        torch.cuda.synchronize()
    return model, opt, scalars


def cpu_spread(model, criterion, batches, make, cpu) -> float:
    """How far the CPU's own run of ``make()`` at 1 thread ends from
    ``cpu``, the run at the default thread count (another summation
    order), in norm: the largest over the parameters."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, _, _ = lenet_method_run(model, criterion, batches, make(), 1,
                                     "cpu")
    finally:
        torch.set_num_threads(threads)
    return max(float((p.detach() - q.detach()).norm() / q.detach().norm())
               for p, q in zip(one.parameters(), cpu.parameters()))


def _state_equal(a, b) -> bool:
    from bigdl_tpu_torch.optim.optimizer import _state_tensors
    ta, tb = _state_tensors(a), _state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def _moved_share(a, b) -> float:
    """The share of entries of two lists of tensors that differ."""
    moved = sum(int((x != y).sum()) for x, y in zip(a, b))
    return moved / max(sum(x.numel() for x in a), 1)


def methods_gate(device="cuda", methods=None, schedules=None,
                 plateau=True) -> dict:
    """(a) of the methods phase: each method on LeNet-5 eagerly on the
    card against a CPU copy, and in windows bit for bit against the
    eager run; each schedule under SGD in windows, its step-scalar tensor
    read back after every replay against the host's float32 sequence;
    Plateau told planted validation scores.  ``methods`` and
    ``schedules`` (names) and ``plateau`` select a part (all by
    default).  Returns the readings and the failed checks."""
    from bigdl_tpu_torch.optim import methods as m
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, criterion, batches = lenet_setup()
    failed, rows = [], {}
    n = len(batches)
    want_stats = {"single_steps": n % METHOD_WINDOW,
                  "window_steps": n - n % METHOD_WINDOW, "captures": 1,
                  "replays": n - n % METHOD_WINDOW}
    for name, make in method_cases().items():
        if methods is not None and name not in methods:
            continue
        eager, e_opt, _ = lenet_method_run(model, criterion, batches, make(),
                                           1, device)
        graph, g_opt, _ = lenet_method_run(model, criterion, batches, make(),
                                           METHOD_WINDOW, device)
        cpu, c_opt, _ = lenet_method_run(model, criterion, batches, make(),
                                         1, "cpu")
        spread = cpu_spread(model, criterion, batches, make, cpu) \
            if name in NORMALISED_METHODS else None
        a = np.array([v for _, v in e_opt.loss_history])
        b = np.array([v for _, v in c_opt.loss_history])
        loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
        norm_rel = max(float((p.detach().cpu() - q.detach()).norm()
                             / q.detach().norm())
                       for p, q in zip(eager.parameters(), cpu.parameters()))
        same_losses = e_opt.loss_history == g_opt.loss_history
        e_params = [p.detach() for p in eager.parameters()]
        g_params = [p.detach() for p in graph.parameters()]
        same_params = all(torch.equal(p, q) for p, q in zip(e_params,
                                                            g_params))
        same_state = _state_equal(e_opt._opt_states, g_opt._opt_states)
        bound = (NORMALISED_NORM_REL if name in NORMALISED_METHODS
                 else METHOD_PARAM_NORM_REL)
        rows[name] = dict(loss_rel=loss_rel, param_norm_rel=norm_rel,
                          cpu_spread=spread, bound=bound,
                          losses=[round(float(v), 6) for v in a],
                          same_losses=same_losses, same_params=same_params,
                          same_state=same_state,
                          params_moved_share=_moved_share(e_params,
                                                          g_params),
                          dispatch=g_opt.dispatch_stats)
        if len(a) != n or not np.all(np.isfinite(a)):
            failed.append(f"{name}: losses not finite or missing: {a}")
        if not (loss_rel <= METHOD_LOSS_RTOL and norm_rel <= bound):
            failed.append(f"{name}: the card differs from the CPU copy: "
                          f"loss {loss_rel:.3e}, parameters {norm_rel:.3e} "
                          "in norm")
        if not (same_losses and same_params and same_state):
            failed.append(f"{name}: the windows are not the eager run (losses"
                          f" {'equal' if same_losses else 'differ'}, "
                          f"parameters {'equal' if same_params else 'differ'}"
                          f", state {'equal' if same_state else 'differ'})")
        if g_opt.dispatch_stats != want_stats:
            failed.append(f"{name}: the windowed run dispatched "
                          f"{g_opt.dispatch_stats}, not {want_stats}")

    read = {}
    steps = SCHEDULE_BATCHES * SCHEDULE_EPOCHS
    for name, make in schedule_cases().items():
        if schedules is not None and name not in schedules:
            continue
        method = m.SGD(0.1, momentum=0.9, dampening=0.0,
                       learning_rate_schedule=make())
        _, opt, got = lenet_method_run(
            model, criterion, batches[:SCHEDULE_BATCHES], method,
            SCHEDULE_BATCHES, device, epochs=SCHEDULE_EPOCHS)
        host = make()
        want = [float(np.float32(host(0.1, t, 1 + t // SCHEDULE_BATCHES)))
                for t in range(steps)]
        got = [r[0][0] for r in got]
        wrong = sum(g != w for g, w in zip(got, want))
        read[name] = dict(rates=got, want=want, wrong=wrong,
                          replays=opt.dispatch_stats["replays"])
        if len(got) != steps or wrong or \
                opt.dispatch_stats["replays"] != steps:
            failed.append(f"{name}: the replays read {got}, the host's "
                          f"sequence is {want} ({opt.dispatch_stats})")

    signs = lenet_grad_signs(model, criterion, batches[0], device) \
        if methods is None else None
    if plateau:
        r = read["Plateau"] = plateau_run(model, criterion, batches, device)
        if r["wrong"] or r["reductions"] != 2:
            failed.append(f"Plateau: the steps read {r['rates']}, the "
                          f"planted scores give {r['want']} "
                          f"({r['reductions']} reductions)")
    return dict(methods=rows, schedules=read, grad_signs=signs,
                failed=failed)


def lenet_grad_signs(model, criterion, batch, device):
    """The first step's gradients of ``model`` on ``batch`` on ``device``
    and on the CPU: the entries whose signs differ, and the largest
    |gradient| among them (where a sign step method moves the two runs
    apart)."""
    import copy
    grads = []
    for dev in (device, "cpu"):
        m = copy.deepcopy(model).to(dev)
        x, y = (torch.as_tensor(v, device=dev) for v in batch)
        criterion(m(x), y).backward()
        grads.append([p.grad.detach().cpu() for p in m.parameters()])
    flips = [torch.sign(a) != torch.sign(b) for a, b in zip(*grads)]
    largest = max((float(torch.abs(b[f]).max()) for b, f in
                   zip(grads[1], flips) if f.any()), default=0.0)
    return dict(entries=sum(int(f.sum()) for f in flips),
                of=sum(f.numel() for f in flips), largest_abs=largest)


def plateau_run(model, criterion, batches, device):
    """SGD under Plateau(0.5, patience 2, cooldown 2) on LeNet-5 for
    PLATEAU_STEPS iterations in windows of PLATEAU_EVERY, a validation
    every PLATEAU_EVERY iterations scoring PLATEAU_SCORES: the rate each
    step read against the host's, told the same scores after the same
    steps."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.optim import methods as m

    def make():
        return m.Plateau(factor=0.5, patience=2, cooldown=2)
    schedule = make()
    val = DataSet.array([MiniBatch(*batches[0])], shuffle=False)

    def configure(opt):
        opt.set_validation(Trigger.several_iteration(PLATEAU_EVERY), val,
                           [PlantedScore(PLATEAU_SCORES)])
    epochs = PLATEAU_STEPS // SCHEDULE_BATCHES
    _, opt, got = lenet_method_run(
        model, criterion, batches[:SCHEDULE_BATCHES],
        m.SGD(0.1, learning_rate_schedule=schedule), PLATEAU_EVERY, device,
        epochs=epochs, configure=configure)
    # the host's: a trigger reads neval after the step's increment, so a
    # validation follows every step whose number + 1 is a multiple
    host, scores, want = make(), iter(PLATEAU_SCORES), []
    for step in range(1, PLATEAU_STEPS + 1):
        want.append(host(0.1, step - 1, 1))
        if (step + 1) % PLATEAU_EVERY == 0:
            host.on_metric(next(scores))
    got = [r[0][0] for r in got]
    factors = sorted({round(v / 0.1, 6) for v in want}, reverse=True)
    return dict(rates=got, want=want,
                wrong=sum(g != w for g, w in zip(got, want))
                + abs(len(got) - len(want)),
                reductions=len(factors) - 1,
                factor=schedule.current_factor,
                replays=opt.dispatch_stats["replays"])


def adam_update_reading(model, rates) -> dict:
    """Adam's update over ``model``'s parameters with their gradients as
    the last step left them, from a fresh state: CUDA-event ms (median
    of ADAM_TIMED), the device's kernels and busy ms a call (torch.
    profiler), and the bound: an elementwise pass reading p, g, m and v
    and writing p, m and v, in float32, over the card's memory rate."""
    from bigdl_tpu_torch.optim import methods as m
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    adam = m.Adam()
    state = adam.init_state(params)
    scalars = [torch.tensor(v, device=params[0].device)
               for v in adam.step_scalars(state, 1)]
    adam.apply(grads, params, state, *scalars)

    times = []
    for _ in range(ADAM_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        adam.apply(grads, params, state, *scalars)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    _, framed = traced_call(lambda: adam.apply(grads, params, state,
                                               *scalars))
    events = device_events(framed)
    numel = sum(p.numel() for p in params)
    moved = 7 * 4 * numel
    return dict(ms=float(np.median(times)), kernels=len(events),
                busy_ms=sum(e.time_range.elapsed_us() for e in events) / 1e3,
                tensors=len(params), numel=numel, bytes=moved,
                bound_ms=moved / rates[0] * 1e3)


def adam_lm_reading(rates, sgd=None) -> dict:
    """(b): the LM at phase 6's width with Adam at the reference's
    defaults, eagerly and in windows of ADAM_ITERS, deterministic
    algorithms on: losses, parameters and Adam's state bit for bit; #1-#3
    at a step's worth each step, as under SGD, by the tensor-core route;
    Adam's update timed."""
    from bigdl_tpu_torch.optim import methods as m
    per_step = DISPATCH_PATHS["lm"][1]
    steps = ADAM_ITERS * ADAM_EPOCHS

    def adam(opt):
        opt.set_optim_method(m.Adam())
    with deterministic() as nondet:
        eager = dispatch_reading("lm", 1, ADAM_ARGV, adam)
        graph = dispatch_reading("lm", ADAM_ITERS, ADAM_ARGV, adam)
    failed = []
    e_opt, g_opt = eager["opt"], graph["opt"]
    same_losses = e_opt.loss_history == g_opt.loss_history
    same_params = all(torch.equal(p, q) for p, q in zip(
        eager["model"].parameters(), graph["model"].parameters()))
    same_state = _state_equal(e_opt._opt_states, g_opt._opt_states)
    losses = [v for _, v in e_opt.loss_history]
    if not (same_losses and same_params and same_state):
        failed.append(f"LM + Adam: the windows are not the eager run (losses "
                      f"{'equal' if same_losses else 'differ'}, parameters "
                      f"{'equal' if same_params else 'differ'}, state "
                      f"{'equal' if same_state else 'differ'})")
    if len(losses) != steps or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        failed.append(f"LM + Adam: losses not finite, missing or not "
                      f"falling: {losses}")
    want_stats = {"single_steps": 0, "window_steps": steps, "captures": 1,
                  "replays": steps}
    if g_opt.dispatch_stats != want_stats:
        failed.append(f"LM + Adam: the windowed run dispatched "
                      f"{g_opt.dispatch_stats}")
    for what, got, n in (("eager wrapper counts", eager["launches"], steps),
                         ("eager device launches", eager["before"], steps),
                         ("graph wrapper counts", graph["launches"], 2),
                         ("graph device launches after the capture",
                          graph["replayed"], steps)):
        want = {k: per_step.get(k, 0) * n for k in got}
        if got != want:
            failed.append(f"LM + Adam: {what} {got}, not {want} (the SGD "
                          f"run's {per_step} a step)")
    for name, count in per_step.items():
        if not routes_are(eager["routes"][name],
                          {"tensor_core": count * steps}):
            failed.append(f"LM + Adam: {name} routes {eager['routes'][name]}")
    update = adam_update_reading(eager["model"], rates)
    return dict(eager=dict(out=eager["out"], busy=eager["busy"],
                           peak=eager["peak"], launches=eager["launches"]),
                graph=dict(out=graph["out"], busy=graph["busy"],
                           peak=graph["peak"], replayed=graph["replayed"]),
                losses=losses, same_losses=same_losses,
                same_params=same_params, same_state=same_state,
                nondeterministic=sorted(nondet), update=update,
                sgd=sgd, failed=failed)


def imagenet_schedule(iters_per_epoch, epochs):
    """The ImageNet recipe's schedule and base rate
    (bigdl_tpu/examples/imagenet.py:284-302)."""
    from bigdl_tpu_torch.optim import methods as m
    total = iters_per_epoch * epochs
    warm = IMAGENET_WARM_EPOCHS * iters_per_epoch
    start = IMAGENET_PEAK_LR / warm
    schedule = (m.SequentialSchedule(iters_per_epoch)
                .add(m.Warmup((IMAGENET_PEAK_LR - start) / warm), warm)
                .add(m.Poly(0.5, total - warm), total - warm))
    return schedule, start


def imagenet_resnet_reading() -> dict:
    """(c): ResNet-50 (b128, 224 px, fused, bf16) with the ImageNet
    recipe in windows of an epoch: the rate tensor each replay read
    against the host's sequence, moving every step; #8-#11 at
    32/32/13/13 a step on the device."""
    from bigdl_tpu_torch.optim import methods as m
    steps = RESNET_ITERS * RESNET_EPOCHS
    schedule, start = imagenet_schedule(RESNET_ITERS, RESNET_EPOCHS)
    recorded = {}

    def recipe(opt):
        opt.set_optim_method(m.SGD(start, momentum=0.9, dampening=0.0,
                                   weight_decay=1e-4, nesterov=True,
                                   learning_rate_schedule=schedule))
        recorded["rates"] = record_scalars(opt)
    r = dispatch_reading("resnet", RESNET_ITERS, RESNET_ARGV, recipe)
    host, _ = imagenet_schedule(RESNET_ITERS, RESNET_EPOCHS)
    want = [host(start, t, 1 + t // RESNET_ITERS) for t in range(steps)]
    got = [x[0][0] for x in recorded["rates"]]
    failed = []
    if got != want:
        failed.append(f"ImageNet recipe: the replays read {got}, the host's "
                      f"sequence is {want}")
    if any(a == b for a, b in zip(got, got[1:])):
        failed.append(f"ImageNet recipe: the rate did not move on every "
                      f"replay: {got}")
    losses = [v for _, v in r["opt"].loss_history]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        failed.append(f"ImageNet recipe: losses not finite or missing: "
                      f"{losses}")
    want_replayed = {k: RESNET_LAUNCHES.get(k, 0) * steps
                     for k in r["replayed"]}
    if r["replayed"] != want_replayed or \
            r["opt"].dispatch_stats["replays"] != steps:
        failed.append(f"ImageNet recipe: device launches after the capture "
                      f"{r['replayed']}, not {want_replayed} "
                      f"({r['opt'].dispatch_stats})")
    return dict(out=r["out"], busy=r["busy"], peak=r["peak"], rates=got,
                losses=losses, replayed=r["replayed"],
                dispatch=r["opt"].dispatch_stats, failed=failed)


def _chance(k, neg):
    """HitRatio@k and NDCG@k of a random ranking of 1 + neg items."""
    hr = min(k, 1 + neg) / (1 + neg)
    ndcg = sum(1 / np.log2(r + 1) for r in range(1, min(k, 1 + neg) + 1)) \
        / (1 + neg)
    return hr, float(ndcg)


def _samples_per_s(opt, batch) -> float:
    steady = opt.window_timings[1:]
    return sum(n for n, _, _ in steady) * batch / sum(
        dt for _, dt, _ in steady)


def examples_reading(device="cuda") -> dict:
    """(d): the NCF example at MovieLens-1M's widths and the autoencoder
    example on the card: NCF's HitRatio@10 and NDCG@10 above chance, the
    autoencoder's loss falling, samples/s of both."""
    from bigdl_tpu_torch.dataset.movielens import synthetic_ratings
    from bigdl_tpu_torch.examples import autoencoder, ncf
    failed = []
    ratings = synthetic_ratings(n_users=NCF_USERS, n_items=NCF_ITEMS,
                                per_user=NCF_PER_USER)
    args = ncf.parse_args(NCF_ARGV + ["--device", device])
    t0 = time.perf_counter()
    _, opt = ncf.train(args, ratings=ratings)
    ncf_wall = time.perf_counter() - t0
    results = {name: r.result()[0] for name, r in
               opt.validation_history[-1][1].items()}
    hr, ndcg = results[f"HitRatio@{args.topk}"], results[f"NDCG@{args.topk}"]
    chance = _chance(args.topk, args.neg_eval)
    if not (hr > chance[0] and ndcg > chance[1]):
        failed.append(f"NCF: HitRatio {hr} and NDCG {ndcg} not above chance "
                      f"{chance}")
    ncf_r = dict(hit_ratio=hr, ndcg=ndcg, chance=chance,
                 samples_per_s=_samples_per_s(opt, args.batch_size),
                 wall=ncf_wall, steps=opt.state["neval"] - 1,
                 records=opt.state["records"],
                 losses=(opt.loss_history[0][1], opt.loss_history[-1][1]),
                 validations=[(n, {k: v.result()[0] for k, v in r.items()})
                              for n, r in opt.validation_history])
    args = autoencoder.parse_args(AUTOENCODER_ARGV + ["--device", device])
    t0 = time.perf_counter()
    _, opt = autoencoder.train(args)
    ae_wall = time.perf_counter() - t0
    losses = [v for _, v in opt.loss_history]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        failed.append(f"autoencoder: the loss did not fall: {losses[0]} -> "
                      f"{losses[-1]}")
    ae_r = dict(losses=(losses[0], losses[-1]), steps=len(losses),
                samples_per_s=_samples_per_s(opt, args.batch_size),
                wall=ae_wall,
                validation=[r["Loss"].result()[0] if "Loss" in r else
                            next(iter(r.values())).result()[0]
                            for _, r in opt.validation_history])
    return dict(ncf=ncf_r, autoencoder=ae_r, failed=failed)


def methods_reading(rates, sgd=None) -> dict:
    """The methods phase's readings and failed checks: TF32 off, (a) the
    gate, (b) the LM with Adam, (c) ResNet-50 with the ImageNet recipe,
    (d) the NCF and autoencoder examples, each path's launches of #1-#11
    read from zeroed counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    failed = []
    launches = {}
    _zero_counts()
    with deterministic():
        gate = methods_gate()
    launches["methods_lenet"] = _read_counts()
    lm = adam_lm_reading(rates, sgd)
    launches["methods_lm_adam_training"] = lm["eager"]["launches"]
    resnet = imagenet_resnet_reading()
    launches["methods_resnet_imagenet_recipe_graph_replays"] = \
        resnet["replayed"]
    _zero_counts()
    examples = examples_reading()
    launches["methods_examples"] = _read_counts()
    for path in ("methods_lenet", "methods_examples"):
        if any(launches[path].values()):
            failed.append(f"{path} launched a kernel of #1-#11: "
                          f"{launches[path]}")
    return dict(gate=gate, lm=lm, resnet=resnet, examples=examples,
                launches=launches, seconds=time.perf_counter() - t0,
                failed=failed + [f"gate: {f}" for f in gate["failed"]]
                + lm["failed"] + resnet["failed"] + examples["failed"])


def phase_methods(smi, rates, sgd=None):
    """13h: every optim method, schedule and recipe; see methods_reading.
    ``sgd`` is the dispatch phase's reading of the LM under SGD, printed
    beside Adam's."""
    def report(r):
        for name, x in r["gate"]["methods"].items():
            print(f"methods: {name} on LeNet-5 (b256 f32, {METHOD_BATCHES} "
                  f"steps): card against CPU loss {x['loss_rel']:.3e}, "
                  f"parameters {x['param_norm_rel']:.3e} in norm (bound "
                  f"{x['bound']:.0e}"
                  + ("" if x["cpu_spread"] is None else
                     f"; the CPU at 1 thread against "
                     f"{torch.get_num_threads()}: {x['cpu_spread']:.3e}")
                  + f"); windows "
                  f"of {METHOD_WINDOW} against eager: losses "
                  f"{'equal' if x['same_losses'] else 'DIFFER'}, parameters "
                  f"{'equal' if x['same_params'] else 'DIFFER'} (moved "
                  f"share {x['params_moved_share']:.3e}), state "
                  f"{'equal' if x['same_state'] else 'DIFFER'}; dispatch "
                  f"{x['dispatch']}; losses {x['losses']}", flush=True)
        g = r["gate"]["grad_signs"]
        print(f"methods: LeNet-5's first gradients, card against CPU: "
              f"{g['entries']} of {g['of']} entries of opposite sign, the "
              f"largest |g| among them {g['largest_abs']:.3e}", flush=True)
        for name, x in r["gate"]["schedules"].items():
            print(f"methods: schedule {name}: {x['replays']} replays read "
                  f"{[float(np.float32(v)) for v in x['rates']]}; "
                  f"{x['wrong']} off the host's sequence", flush=True)
        lm, up = r["lm"], r["lm"]["update"]
        for label in ("eager", "graph"):
            x = lm[label]
            sgd = lm["sgd"] or {}
            print(f"methods: LM + Adam {label}: "
                  f"{x['out']['ms_per_iteration']} ms/iteration (under "
                  f"torch.profiler), device busy {x['busy']:.3f} ms per "
                  f"step, peak memory {x['peak']} bytes; SGD's {label} run "
                  f"in the dispatch phase: {sgd.get(label + '_ms')} "
                  f"ms/iteration, busy {sgd.get(label + '_busy')}, peak "
                  f"{sgd.get(label + '_peak')}", flush=True)
        print(f"methods: LM + Adam: launches of #1-#3 eager "
              f"{ {k: lm['eager']['launches'][k] for k in DISPATCH_PATHS['lm'][1]} }"
              f", replayed {ADAM_ITERS * ADAM_EPOCHS} steps "
              f"{ {k: lm['graph']['replayed'][k] for k in DISPATCH_PATHS['lm'][1]} }"
              f"; windows against eager: losses "
              f"{'equal' if lm['same_losses'] else 'DIFFER'}, parameters "
              f"{'equal' if lm['same_params'] else 'DIFFER'}, Adam state "
              f"{'equal' if lm['same_state'] else 'DIFFER'}; loss "
              f"{lm['losses'][0]:.6f} -> {lm['losses'][-1]:.6f}; "
              f"nondeterministic {lm['nondeterministic'] or 'none'}",
              flush=True)
        print(f"methods: Adam's update over the LM's {up['tensors']} "
              f"tensors ({up['numel']} parameters): {up['ms']:.4f} ms "
              f"(CUDA events, median of {ADAM_TIMED}), {up['kernels']} "
              f"kernels and {up['busy_ms']:.4f} ms busy a call "
              f"(torch.profiler); bound {up['bound_ms']:.4f} ms "
              f"({up['bytes']} bytes at the card's memory rate); on {smi}",
              flush=True)
        rn = r["resnet"]
        print(f"methods: ResNet-50 + ImageNet recipe (windows of "
              f"{RESNET_ITERS}): {rn['out']['ms_per_iteration']} "
              f"ms/iteration, busy {rn['busy']:.3f} ms per step; rates read "
              f"{rn['rates']}; device launches after the capture "
              f"{ {k: rn['replayed'][k] for k in RESNET_LAUNCHES} } over "
              f"{rn['dispatch']['replays']} replays; loss "
              f"{rn['losses'][0]:.6f} -> {rn['losses'][-1]:.6f}", flush=True)
        nc, ae = r["examples"]["ncf"], r["examples"]["autoencoder"]
        print(f"methods: NCF ({NCF_USERS} users, {NCF_ITEMS} items, "
              f"{nc['records']} records over {nc['steps']} steps): "
              f"{nc['samples_per_s']:.1f} samples/s (steady windows), "
              f"{nc['wall']:.2f} s with validation; HitRatio@10 "
              f"{nc['hit_ratio']:.4f}, NDCG@10 {nc['ndcg']:.4f} (chance "
              f"{nc['chance'][0]:.4f}, {nc['chance'][1]:.4f}); validations "
              f"{nc['validations']}; loss {nc['losses'][0]:.5f} -> "
              f"{nc['losses'][1]:.5f}", flush=True)
        print(f"methods: autoencoder ({ae['steps']} steps): "
              f"{ae['samples_per_s']:.1f} samples/s, {ae['wall']:.2f} s; "
              f"loss {ae['losses'][0]:.5f} -> {ae['losses'][1]:.5f}; "
              f"validation losses {ae['validation']}", flush=True)
        print(f"methods: launches of #1-#11 by path "
              f"{ {p: sum(c.values()) for p, c in r['launches'].items()} }; "
              f"TF32 off; {r['seconds']:.1f} s; on {smi}", flush=True)
    return _phase("methods", lambda: methods_reading(rates, sgd), report)


# ---------------------------------------------------------------------------
# 13i. int8: the quantized layers, int8 ResNet-50 and int8 SSD-300
# ---------------------------------------------------------------------------

# Published dense int8 peak at the full power limit (NVIDIA data sheet,
# no sparsity), operations/s
INT8_PEAK = {"H100 80GB HBM3": 1979e12, "H200": 1979e12}
INT8_RUNS, INT8_PLAIN_RUNS = 60, 10     # timed runs a row (median)
# the int8 gate's rows at ResNet-50's and SSD-300's layer shapes, b32:
# (name, the float layer from (generator, device), the input's shape)
INT8_ROWS = (
    ("stem_7x7s2", lambda nn, g, d: nn.SpatialConvolution(
        3, 64, 7, 7, 2, 2, 3, 3, with_bias=False, generator=g, device=d),
     (32, 224, 224, 3)),
    ("conv1x1", lambda nn, g, d: nn.SpatialConvolution(
        64, 256, 1, 1, with_bias=False, generator=g, device=d),
     (32, 56, 56, 64)),
    ("conv3x3s2", lambda nn, g, d: nn.SpatialConvolution(
        128, 128, 3, 3, 2, 2, 1, 1, with_bias=False, generator=g, device=d),
     (32, 56, 56, 128)),
    ("fc6_dilated6", lambda nn, g, d: nn.SpatialDilatedConvolution(
        512, 1024, 3, 3, 1, 1, 6, 6, 6, 6, generator=g, device=d),
     (32, 19, 19, 512)),
    ("head_1000", lambda nn, g, d: nn.Linear(2048, 1000, generator=g,
                                             device=d), (32, 2048)),
    ("head_1000_b1_1d", lambda nn, g, d: nn.Linear(2048, 1000, generator=g,
                                                   device=d), (2048,)),
)
# int8 against f32 logits at b32 (tests/test_quantized.py:162's bounds)
INT8_REL_L2, INT8_TOP1 = 0.05, 0.75
# the card's int8 ResNet-50 against a CPU copy of the same int8 model
INT8_CPU_BATCH, INT8_CPU_REL_L2 = 2, 1e-3
INT8_ARGV = ["--int8-infer", "-b", "32", "--image-size", "224",
             "--classes", "1000"]
INT8_SSD_IOU = 0.5          # a kept f32 detection the int8 model keeps


@contextmanager
def plain_products():
    """The int8 layers' products swapped for their float64 plain versions
    inside (the module's ``int8_matmul`` and ``int8_conv``)."""
    from bigdl_tpu_torch.nn import quantized as q
    saved = q.int8_matmul, q.int8_conv
    q.int8_matmul, q.int8_conv = q.plain_int8_matmul, q.plain_int8_conv
    try:
        yield
    finally:
        q.int8_matmul, q.int8_conv = saved


def ulps_apart(a, b) -> int:
    """The largest distance in float32 ulps between ``a`` and ``b``."""
    ia = a.float().contiguous().cpu().view(torch.int32).long()
    ib = b.float().contiguous().cpu().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def int8_row(name, make, shape, rates, peak, flush, device="cuda",
             timed=True):
    """One int8 gate row: the layer quantized on the card and on a CPU
    copy from the same float weights and input; ``qweight``, ``wscale``,
    the int8 activations and scales equal; the card's ``_int_mm`` sums
    equal its float64 plain version's and the CPU's; its output equal
    the plain version's through the same epilogue and within 1 ulp of
    the CPU's; times of the int8 layer, its plain version and the f32
    layer (the yardstick) and the int8 bound."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import quantized as q
    failed = []
    g = torch.Generator().manual_seed(17)
    cpu_layer = make(nn, g, "cpu")
    layer = _copy_to(cpu_layer, device)
    x_cpu = torch.randn(shape, generator=g)
    x = x_cpu.to(device)
    ql, ql_cpu = q.quantize(layer), q.quantize(cpu_layer)
    rows = (lambda t: t[None]) if x.dim() == 1 else (lambda t: t)
    with torch.no_grad():
        for what in ("qweight", "wscale"):
            if not torch.equal(getattr(ql, what).cpu(),
                               getattr(ql_cpu, what)):
                failed.append(f"{name}: {what} differs from the CPU's")
        with int_mm_calls() as int_mm:
            qx, sx, acc = ql.accumulate(rows(x))
        int_mm = int_mm[0]
        conv = x.dim() == 4
        failed += definition_held(f"{name}: activations", qx, sx,
                                  rows(x_cpu))
        failed += definition_held(
            f"{name}: weights", ql.qweight, ql.wscale,
            cpu_layer.weight.detach(), 3 if conv else 0)
        with plain_products():
            plain = ql.accumulate(rows(x))[2]
        cqx, csx, cacc = ql_cpu.accumulate(rows(x_cpu))
        if not (torch.equal(qx.cpu(), cqx) and torch.equal(sx.cpu(), csx)):
            failed.append(f"{name}: the int8 activations or their scales "
                          "differ from the CPU's")
        if not torch.equal(acc, plain):
            failed.append(f"{name}: the _int_mm sums differ from the "
                          "float64 plain version's")
        if not torch.equal(acc.cpu(), cacc):
            failed.append(f"{name}: the card's int32 sums differ from the "
                          "CPU's")
        out = ql(x)
        with plain_products():
            out_plain = ql(x)
        cpu_ulps = ulps_apart(out, ql_cpu(x_cpu))
        if not torch.equal(out, out_plain):
            failed.append(f"{name}: the output differs from the plain "
                          "version's")
        if cpu_ulps > 1:
            failed.append(f"{name}: the output is {cpu_ulps} ulps off the "
                          "CPU's")
        if int_mm < 1:
            failed.append(f"{name}: the layer ran no torch._int_mm")
        ms = plain_ms = f32_ms = None
        if timed:
            ms = time_ms(lambda: ql(x), flush, runs=INT8_RUNS)
            with plain_products():
                plain_ms = time_ms(lambda: ql(x), flush,
                                   runs=INT8_PLAIN_RUNS, warmup=1)
            f32_ms = time_ms(lambda: layer(x), flush, runs=INT8_RUNS)
    k = ql.qweight.numel() // ql.qweight.shape[-1 if conv else 0]
    ops = 2 * acc.numel() * k
    nbytes = (4 * x.numel() + ql.qweight.numel() + 4 * ql.wscale.numel()
              + (0 if ql.bias is None else 4 * ql.bias.numel())
              + 4 * out.numel())
    by_bytes, by_ops = nbytes / rates[0] * 1e3, ops / peak * 1e3
    return dict(shape=name, input=list(shape), int_mm_calls=int_mm,
                ms=ms, plain_ms=plain_ms, f32_ms=f32_ms,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                int8_ops=ops, bytes=nbytes, cpu_ulps=cpu_ulps,
                max_abs_err=float((out - out_plain).abs().max()),
                failed=failed)


def _copy_to(module, device):
    import copy
    return copy.deepcopy(module).to(device)


def int8_definition(v, channel_axis=None):
    """The reference's quantization of ``v`` in numpy, float32 (its
    rules, written out once more): max-abs over every axis but the batch
    (``channel_axis`` None: axis 0 kept, a row's scale) or but
    ``channel_axis``, scale = amax / 127 where amax > 0 else 1, round
    half to even, clip to [-127, 127]."""
    v = np.asarray(v, np.float32)
    keep = 0 if channel_axis is None else channel_axis
    axes = tuple(i for i in range(v.ndim) if i != keep)
    amax = np.abs(v).max(axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127),
                     np.float32(1)).astype(np.float32)
    return np.clip(np.round(v / scale), -127, 127).astype(np.int8), scale


def definition_held(what, q, scale, v, channel_axis=None):
    """The failed checks of int8 values ``q`` and their ``scale`` (any
    broadcastable shape) against :func:`int8_definition` of ``v``."""
    want_q, want_s = int8_definition(v, channel_axis)
    failed = []
    if not np.array_equal(q.cpu().numpy(), want_q):
        failed.append(f"{what}: {int((q.cpu().numpy() != want_q).sum())} "
                      "int8 values off the definition (per-channel or "
                      "per-row max-abs / 127, round half to even)")
    if not np.array_equal(scale.cpu().numpy().reshape(-1),
                          want_s.reshape(-1)):
        failed.append(f"{what}: the scales are not the definition's")
    return failed


@contextmanager
def int_mm_calls():
    """Counts the calls of ``torch._int_mm`` that returned, inside (a
    call that raised is not counted)."""
    real, calls = torch._int_mm, [0]

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        return out
    torch._int_mm = counted
    try:
        yield calls
    finally:
        torch._int_mm = real


def planted_ties(device="cuda"):
    """The failed checks of rows and weights whose values lie exactly
    halfway between int8 steps: each rounds to the even step, as
    ``jnp.round`` rounds, and each weight channel keeps its own scale."""
    from bigdl_tpu_torch.nn import quantized as q
    halves = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, -126.5],
                          device=device)
    x = torch.stack([halves, halves * 2, halves / 4])
    qx, sx = q._quantize_rows(x)
    w = torch.stack([halves, halves * 8])
    qw, sw = q._quantize_per_channel(w, 0)
    return (definition_held("planted ties, rows", qx, sx, x.cpu())
            + definition_held("planted ties, weight channels", qw, sw,
                              w.cpu(), 0))


def int8_gate(rates, peak, device="cuda", timed=True):
    """The int8 layers at ResNet-50's and SSD-300's shapes (INT8_ROWS),
    timed unless ``timed`` is False, and the planted ties: (the rows,
    the ties' failed checks)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=device)
    rows = [int8_row(name, make, shape, rates, peak, flush, device, timed)
            for name, make, shape in INT8_ROWS]
    del flush
    return rows, planted_ties(device)


def int8_accuracy(model, x):
    """Relative L2 of the int8 copy's logits to ``model``'s and the share
    of rows whose top-1 class agrees."""
    from bigdl_tpu_torch.nn.quantized import quantize
    qmodel = quantize(model)
    with torch.no_grad():
        out_f, out_q = model(x).float(), qmodel(x).float()
    rel = float((out_q - out_f).norm() / out_f.norm())
    agree = float((out_f.argmax(1) == out_q.argmax(1)).float().mean())
    return rel, agree, bool(torch.isfinite(out_q).all())


def int8_activations(qmodel, x):
    """{layer: its int8 activations} of one forward of ``qmodel``."""
    from bigdl_tpu_torch.nn import quantized as q
    seen, hooks = {}, []
    for name, m in qmodel.named_modules():
        if isinstance(m, (q.QuantizedLinear, q.QuantizedSpatialConvolution)):
            def hook(mod, args, name=name):
                a = args[0]
                if isinstance(mod, q.QuantizedSpatialConvolution) and \
                        mod.data_format == "NCHW":
                    a = a.permute(0, 2, 3, 1)
                seen[name] = q._quantize_rows(a if a.dim() > 1
                                              else a[None])[0].cpu()
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            out = qmodel(x)
    finally:
        for h in hooks:
            h.remove()
    return seen, out


def int8_resnet_reading(device="cuda"):
    """--int8-infer at b32 224 px against the f32 and the bf16 baseline;
    int8 against f32 logits at b32 (the perf CLI's ResNet-50, and the
    oneshot phase's with BatchNorm scales and statistics from a seed);
    the conditioned int8 model on the card against its CPU copy at b2."""
    from bigdl_tpu_torch.examples import perf
    from bigdl_tpu_torch.nn.quantized import quantize
    failed, r = [], {}
    for base in ("fp32", "bf16"):
        argv = INT8_ARGV + (["--bf16"] if base == "bf16" else [])
        _free()
        torch.cuda.reset_peak_memory_stats()
        r[base] = perf.main(argv + ["--device", device], emit=False)
        r[base + "_peak"] = torch.cuda.max_memory_allocated()
        print(f"int8: perf {' '.join(argv)}: {json.dumps(r[base])}",
              flush=True)
    args = perf.parse_args(INT8_ARGV + ["--device", device])
    model, _, make_batch = perf.build("resnet50", args)
    model.eval()
    x = torch.as_tensor(make_batch(args.batch_size)[0], device=device)
    r["perf_model"] = int8_accuracy(model, x)
    del model
    model, cpu = oneshot_resnet_model(device, classes=1000)
    r["conditioned"] = int8_accuracy(model, x)
    for what in ("perf_model", "conditioned"):
        rel, agree, finite = r[what]
        if what == "perf_model" and not (rel < INT8_REL_L2
                                         and agree >= INT8_TOP1 and finite):
            failed.append(f"int8 ResNet-50 ({what}) at b32: relative L2 "
                          f"{rel:.4f} (bound {INT8_REL_L2}), top-1 "
                          f"agreement {agree} (bound {INT8_TOP1})")
    qmodel, qcpu = quantize(model), quantize(cpu)
    xs = x[:INT8_CPU_BATCH]
    card, card_out = int8_activations(qmodel, xs)
    host, host_out = int8_activations(qcpu, xs.cpu())
    r["differing_int8"] = {n: int((card[n] != host[n]).sum())
                           for n in card}
    r["int8_entries"] = {n: card[n].numel() for n in card}
    stem = next(iter(card))
    if r["differing_int8"][stem]:
        failed.append(f"int8 ResNet-50: the stem's int8 activations differ "
                      f"from the CPU's in {r['differing_int8'][stem]} "
                      "entries")
    r["cpu_rel_l2"] = _rel_err(card_out, host_out)
    if not r["cpu_rel_l2"] <= INT8_CPU_REL_L2:
        failed.append(f"int8 ResNet-50: logits {r['cpu_rel_l2']:.3e} off the "
                      f"CPU copy's in norm (bound {INT8_CPU_REL_L2})")
    del model, cpu, qmodel, qcpu
    _free()
    r["failed"] = failed
    return r


def _kept(rows):
    return rows[rows[:, 1] > 0]


def _kept_share(f32_rows, int8_rows) -> float:
    """The share of the f32 model's kept detections that the int8 model
    keeps: same class, IoU at least INT8_SSD_IOU."""
    found = total = 0
    for a, b in zip(f32_rows, int8_rows):
        a, b = _kept(a), _kept(b)
        total += len(a)
        for row in a:
            same = b[b[:, 0] == row[0]]
            if len(same) and _np_box_iou(row[None, 2:], same[:, 2:]).max() \
                    >= INT8_SSD_IOU:
                found += 1
    return found / max(total, 1)


def int8_ssd_reading(device="cuda"):
    """SSD-300 (the detection phase's He-scaled weights, ``ssd_model``)
    quantized: images/s through the Predictor at batch 32 over
    SSD_IMAGES images, peak memory; the card's rows of INT8_CPU_BATCH
    images against a CPU copy of the same int8 model (detections_held);
    the share of the f32 model's kept detections the int8 model keeps,
    printed."""
    import copy
    from bigdl_tpu_torch.nn.quantized import QuantizedSpatialConvolution, \
        quantize
    from bigdl_tpu_torch.optim import Predictor
    failed, r = [], {}
    model = ssd_model(device)
    qmodel = quantize(model)
    qcpu = copy.deepcopy(qmodel).to("cpu")
    r["quantized_convs"] = sum(type(m) is QuantizedSpatialConvolution
                               for m in qmodel.modules())
    images = np.random.default_rng(21).normal(
        size=(SSD_IMAGES, 300, 300, 3)).astype(np.float32)
    predictor = Predictor(qmodel, batch_size=SSD_BATCH, device=device)
    predictor.predict(list(images[:SSD_BATCH]))
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rows = np.stack(predictor.predict(list(images)))
    end.record()
    end.synchronize()
    r["predict_s"] = start.elapsed_time(end) / 1e3
    r["images_per_s"] = SSD_IMAGES / r["predict_s"]
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if rows.shape != (SSD_IMAGES, 200, 6) or not np.isfinite(rows).all():
        failed.append(f"int8 SSD rows of shape {rows.shape}, finite "
                      f"{np.isfinite(rows).all()}")
    f32_rows = np.stack(Predictor(model, batch_size=SSD_BATCH,
                                  device=device).predict(list(images)))
    r["kept_share"] = _kept_share(f32_rows, rows)
    r["kept_per_image"] = (float((f32_rows[:, :, 1] > 0).sum(1).mean()),
                           float((rows[:, :, 1] > 0).sum(1).mean()))
    n = INT8_CPU_BATCH
    with torch.no_grad():
        cloc, cconf, cprior = qcpu.heads(torch.as_tensor(images[:n]))
        cpu_rows = qcpu.detection((cloc, cconf, cprior)).numpy()
    cf = cconf.numpy().reshape(n, -1, SSD_CLASSES)
    r["cpu_near_tie_rows"] = sum(
        _held_rows(rows[i], cpu_rows[i], qmodel.detection, cf[i],
                   f"int8 SSD image {i}: card against CPU", failed)
        for i in range(n))
    del model, qmodel, qcpu, predictor
    _free()
    r["failed"] = failed
    return r


def int8_reading(rates, peak) -> dict:
    """The int8 phase's readings and failed checks, every route counter
    of #1-#11 zeroed before each part and read after."""
    t0 = time.perf_counter()
    launches = {}
    _zero_counts()
    gate, ties = int8_gate(rates, peak)
    launches["int8_gate"] = _read_counts()
    _zero_counts()
    resnet = int8_resnet_reading()
    launches["int8_resnet50"] = _read_counts()
    _zero_counts()
    ssd = int8_ssd_reading()
    launches["int8_ssd"] = _read_counts()
    failed = [f for row in gate for f in row["failed"]] + ties \
        + resnet["failed"] + ssd["failed"]
    for path, counts in launches.items():
        if any(counts.values()):
            failed.append(f"{path} launched a kernel of #1-#11: {counts}")
    return dict(gate=gate, resnet=resnet, ssd=ssd, launches=launches,
                seconds=time.perf_counter() - t0, failed=failed)


def phase_int8(smi, rates):
    """13i: see int8_reading."""
    peak = next((p for key, p in INT8_PEAK.items()
                 if key in torch.cuda.get_device_name(0)), None)
    if peak is None:
        raise RuntimeError("no published int8 peak on file for this card")

    def report(r):
        for row in r["gate"]:
            print(f"int8: {row['shape']} {row['input']}: int8 "
                  f"{row['ms']:.5f} ms ({row['int_mm_calls']} _int_mm), "
                  f"float64 plain {row['plain_ms']:.5f}, f32 layer "
                  f"{row['f32_ms']:.5f} (yardstick); bound "
                  f"{row['bound_ms']:.5f} ms by {row['bound_by']} "
                  f"({row['int8_ops']} int8 operations, {row['bytes']} "
                  f"bytes); the int8 values and scales the definition's, "
                  f"the sums the plain version's and the CPU's; output "
                  f"{row['cpu_ulps']} ulps off the CPU's; on {smi}",
                  flush=True)
        print("int8: planted ties round half to even, each weight channel "
              "with its own scale", flush=True)
        rn = r["resnet"]
        for base in ("fp32", "bf16"):
            x = rn[base]
            print(f"int8: ResNet-50 b32 224 px against {base}: "
                  f"{x[base + '_ms']} ms ({x[base + '_img_per_sec']} "
                  f"images/s), int8 {x['int8_ms']} ms "
                  f"({x['int8_img_per_sec']} images/s), speedup "
                  f"{x['int8_speedup']}; peak memory {rn[base + '_peak']} "
                  f"bytes; on {smi}", flush=True)
        for what in ("perf_model", "conditioned"):
            rel, agree, _ = rn[what]
            print(f"int8: ResNet-50 ({what}) int8 against f32 logits at "
                  f"b32: relative L2 {rel:.5f}, top-1 agreement {agree}",
                  flush=True)
        diff = {n: c for n, c in rn["differing_int8"].items() if c}
        print(f"int8: ResNet-50 (conditioned) card against a CPU copy at "
              f"b{INT8_CPU_BATCH}: logits {rn['cpu_rel_l2']:.3e} in norm; "
              f"int8 activation entries differing by layer "
              f"{diff or 'none'} of {sum(rn['int8_entries'].values())} in "
              f"{len(rn['int8_entries'])} layers", flush=True)
        s = r["ssd"]
        print(f"int8: SSD-300 ({s['quantized_convs']} int8 convolutions) "
              f"through the Predictor at batch {SSD_BATCH}: "
              f"{s['images_per_s']:.2f} images/s ({SSD_IMAGES} images in "
              f"{s['predict_s']:.4f} s), peak memory "
              f"{s['peak_memory_bytes']} bytes; kept per image f32 / int8 "
              f"{s['kept_per_image']}; share of the f32 model's kept "
              f"detections the int8 model keeps {s['kept_share']:.4f}; "
              f"card against CPU at b{INT8_CPU_BATCH}: "
              f"{s['cpu_near_tie_rows']} near-tie rows; on {smi}",
              flush=True)
        print(f"int8: launches of #1-#11 by path "
              f"{ {p: sum(c.values()) for p, c in r['launches'].items()} }; "
              f"{r['seconds']:.1f} s", flush=True)
    return _phase("int8", lambda: int8_reading(rates, peak), report)


# ---------------------------------------------------------------------------
# 13j. layers_9c: the third layer tranche, the text classifier, Tree-LSTM
# ---------------------------------------------------------------------------

def _gen(seed=0):
    return dict(generator=torch.Generator().manual_seed(seed), device="cpu")


def _table(xs):
    return tuple(xs)


def _one(xs):
    return xs[0]


# (name, the layer from nn, its inputs' shapes, how its input is built
# from them (None: the tensors themselves), integer inputs)
LAYERS_9C = (
    ("Identity", lambda nn: nn.Identity(), [(3, 7)], None),
    ("Echo", lambda nn: nn.Echo(), [(3, 4)], None),
    ("Bilinear", lambda nn: nn.Bilinear(4, 5, 3, **_gen()),
     [(6, 4), (6, 5)], _table),
    ("Add", lambda nn: nn.Add(7, **_gen()), [(3, 7)], None),
    ("Mul", lambda nn: nn.Mul(**_gen()), [(3, 7)], None),
    ("Cosine", lambda nn: nn.Cosine(4, 3, **_gen()), [(5, 4)], None),
    ("Euclidean", lambda nn: nn.Euclidean(4, 3, **_gen()), [(5, 4)], None),
    ("Maxout", lambda nn: nn.Maxout(4, 3, 2, **_gen()), [(5, 4)], None),
    ("Highway", lambda nn: nn.Highway(5, activation=nn.ReLU(), **_gen()),
     [(4, 5)], None),
    ("LookupTable_max_norm_mask", lambda nn: nn.LookupTable(
        20, 8, padding_value=3.0, max_norm=1.0, mask_zero=True, **_gen()),
     [], None),
    ("GlobalAveragePooling3D", lambda nn: nn.GlobalAveragePooling3D(),
     [(2, 4, 4, 4, 3)], None),
    ("GlobalMaxPooling3D", lambda nn: nn.GlobalMaxPooling3D(),
     [(2, 4, 4, 4, 3)], None),
    ("TemporalMaxPooling", lambda nn: nn.TemporalMaxPooling(3, 2),
     [(2, 9, 4)], None),
    ("VolumetricMaxPooling", lambda nn: nn.VolumetricMaxPooling(
        3, 3, 3, 2, 2, 2, 1, 1, 1), [(1, 5, 5, 5, 2)], None),
    ("VolumetricAveragePooling", lambda nn: nn.VolumetricAveragePooling(
        3, 3, 3, 2, 2, 2, ceil_mode=True, count_include_pad=False),
     [(1, 6, 6, 6, 2)], None),
    ("UpSampling1D", lambda nn: nn.UpSampling1D(2), [(2, 5, 3)], None),
    ("UpSampling2D", lambda nn: nn.UpSampling2D((2, 3)), [(2, 4, 4, 3)],
     None),
    ("UpSampling3D", lambda nn: nn.UpSampling3D((2, 2, 2)),
     [(1, 3, 3, 3, 2)], None),
    ("ResizeBilinear", lambda nn: nn.ResizeBilinear(3, 2),
     [(2, 7, 5, 3)], None),
    ("ResizeBilinear_align", lambda nn: nn.ResizeBilinear(
        7, 9, align_corners=True), [(2, 4, 5, 3)], None),
    ("SpatialSeparableConvolution", lambda nn:
     nn.SpatialSeparableConvolution(3, 4, 2, 3, 3, 2, 2, -1, -1, **_gen()),
     [(2, 8, 8, 3)], None),
    ("TemporalConvolution", lambda nn: nn.TemporalConvolution(
        4, 5, 3, 2, **_gen()), [(2, 9, 4)], None),
    ("VolumetricFullConvolution", lambda nn: nn.VolumetricFullConvolution(
        2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 1, 1, 1, **_gen()),
     [(1, 3, 3, 3, 2)], None),
    ("LocallyConnected2D", lambda nn: nn.LocallyConnected2D(
        2, 7, 7, 3, 3, 3, 2, 2, 1, 1, **_gen()), [(2, 7, 7, 2)], None),
    ("LocallyConnected1D", lambda nn: nn.LocallyConnected1D(
        9, 3, 2, 3, 2, **_gen()), [(2, 9, 3)], None),
    ("SpatialConvolutionMap", lambda nn: nn.SpatialConvolutionMap(
        nn.SpatialConvolutionMap.random(4, 5, 2, seed=1), 3, 3, 2, 2,
        n_input_plane=4, n_output_plane=5, **_gen()), [(2, 7, 7, 4)], None),
    *((name, (lambda nn, name=name: getattr(nn, name)()),
       [(3, 5), (3, 5)], _table)
      for name in ("CAddTable", "CSubTable", "CMulTable", "CMaxTable",
                   "CMinTable", "CAveTable", "DotProduct", "CosineDistance",
                   "PairwiseDistance")),
    ("CDivTable", lambda nn: nn.CDivTable(), [(3, 5), (3, 5)],
     lambda xs: (xs[0], xs[1].abs() + 0.5)),
    ("JoinTable", lambda nn: nn.JoinTable(1, n_input_dims=1),
     [(3, 4), (3, 2)], _table),
    ("SplitTable", lambda nn: nn.SplitTable(2), [(3, 4)], _one),
    ("SelectTable", lambda nn: nn.SelectTable(-1), [(3, 4), (3, 4)],
     _table),
    ("NarrowTable", lambda nn: nn.NarrowTable(2, 2),
     [(3, 4), (3, 4), (3, 4)], _table),
    ("FlattenTable", lambda nn: nn.FlattenTable(), [(3, 4), (3, 4), (3, 4)],
     lambda xs: [xs[0], (xs[1], (xs[2],))]),
    ("MixtureTable", lambda nn: nn.MixtureTable(), [(3, 2), (3, 4), (3, 4)],
     lambda xs: [xs[0], (xs[1], xs[2])]),
    ("MM", lambda nn: nn.MM(True, True), [(3, 5, 4), (3, 6, 5)], _table),
    ("MV", lambda nn: nn.MV(True), [(2, 4, 3), (2, 4)], _table),
    ("BifurcateSplitTable", lambda nn: nn.BifurcateSplitTable(2), [(3, 5)],
     _one),
    ("CrossProduct", lambda nn: nn.CrossProduct(), [(3, 4), (3, 4), (3, 4)],
     _table),
    ("TableOperation", lambda nn: nn.TableOperation(nn.CMulTable()),
     [(3, 4), (3, 1)], _table),
    ("BinaryTreeLSTM", lambda nn: nn.BinaryTreeLSTM(5, 4, **_gen()), [],
     None),
)
LAYER_TOL = F32_TOL
# the two examples at their defaults (seq 200, vocab 20000, embed 128,
# 128 filters of width 5, b32, SGD 0.05; embed 64, hidden 64, 128 nodes,
# 64 tokens, vocab 2000, b32, Adagrad 0.05) on synthetic data: TEXT_N
# samples (80% trained: 32 steps an epoch) and TREE_N trees (4 steps
# an epoch: eager, its loop of 128 slots takes about a second a step on
# the host), EXAMPLE_EPOCHS epochs; the idle share from a short run of
# EXAMPLE_BUSY_N samples
TEXT_N, TREE_N, EXAMPLE_EPOCHS, EXAMPLE_WINDOW = 1280, 128, 2, 4
EXAMPLE_BUSY_N = {"text_classifier": 160, "treelstm": 128}


def _flat(y):
    if isinstance(y, (tuple, list)):
        return torch.cat([_flat(t).reshape(-1) for t in y])
    return y


def _tree_inputs(rng):
    from bigdl_tpu_torch.examples import treelstm_sentiment as ts
    parsed = ts._synthetic_trees(4, 40, 15, seed=0)
    toks, ch, leaf, _ = ts.trees_to_arrays(parsed, ts.vocabulary(parsed, 40),
                                          15, 8)
    return [rng.standard_normal((4, 8, 5)).astype(np.float32), ch, leaf]


def layer_case(name, make, shapes, pack, device="cuda"):
    """One layer forward and backward on the card against a CPU copy:
    (the largest error of the output, the input gradients and the
    parameter gradients, relative to LAYER_TOL; the failed checks)."""
    from bigdl_tpu_torch import nn
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("LookupTable"):
        inputs = [np.asarray([[1, 5, 20], [3, 3, 7]], np.int64)]
    elif name == "BinaryTreeLSTM":
        inputs = _tree_inputs(rng)
    else:
        inputs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cpu = make(nn)
    card = _copy_to(cpu, device)
    runs = []
    for m, dev in ((cpu, "cpu"), (card, device)):
        xs = [torch.tensor(a, device=dev) for a in inputs]
        for x in xs:
            if x.is_floating_point():
                x.requires_grad_(True)
        arg = pack(xs) if pack is not None else (
            tuple(xs) if name == "BinaryTreeLSTM" else xs[0])
        y = _flat(m(arg))
        cot = torch.tensor(np.random.default_rng(50).standard_normal(
            tuple(y.shape)).astype(np.float32), device=dev)
        (y * cot).sum().backward()
        runs.append([y.detach().cpu()]
                    + [x.grad.cpu() if x.grad is not None
                       else torch.zeros(x.shape) for x in xs
                       if x.is_floating_point()]
                    + [p.grad.cpu() for p in m.parameters()])
    worst, failed = 0.0, []
    for want, got in zip(*runs):
        err = (got - want).abs() - LAYER_TOL["rtol"] * want.abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    if not worst <= LAYER_TOL["atol"]:
        failed.append(f"{name}: the card's forward or backward is "
                      f"{worst:.3e} beyond rtol {LAYER_TOL['rtol']} of the "
                      f"CPU's (atol {LAYER_TOL['atol']})")
    return worst, failed


def tree_definition(model, x, children, leaf_ids):
    """``BinaryTreeLSTM``'s hidden states by the reference's rules
    (nn/BinaryTreeLSTM.scala), node by node in float64 numpy: a leaf's
    (c, o) from its token, an internal node's gates from [h_left,
    h_right] (a missing child the zero state), a padding slot the
    previous slot's state."""
    w = {n: p.detach().double().cpu().numpy()
         for n, p in model.named_parameters()}
    hid = model.hidden_size
    x = np.asarray(x, np.float64)

    def sig(z):
        return 1.0 / (1.0 + np.exp(-z))

    def out_gate(o, c):
        return o * np.tanh(c) if model.gate_output else np.tanh(c)

    zero = np.zeros(hid)
    states = np.zeros(children.shape[:2] + (hid,))
    for b in range(children.shape[0]):
        h, c = {}, {}
        for i, ((left, right), lid) in enumerate(zip(children[b],
                                                     leaf_ids[b])):
            if lid >= 0:
                proj = w["leaf_w"] @ x[b, lid] + w["leaf_b"]
                c[i] = proj[:hid]
                h[i] = out_gate(sig(proj[hid:]), c[i])
            elif left < 0 and right < 0:
                h[i], c[i] = h.get(i - 1, zero), c.get(i - 1, zero)
            else:
                hl, hr = h.get(left, zero), h.get(right, zero)
                cl, cr = c.get(left, zero), c.get(right, zero)
                g = w["comp_w"] @ np.concatenate([hl, hr]) + w["comp_b"]
                gi, gl, gr, gu, go = (g[k * hid:(k + 1) * hid]
                                      for k in range(5))
                c[i] = sig(gi) * np.tanh(gu) + sig(gl) * cl + sig(gr) * cr
                h[i] = out_gate(sig(go), c[i])
            states[b, i] = h[i]
    return states


def tree_held(device="cuda"):
    """The Tree-LSTM example's tree layer (embed 64, hidden 64, 128
    slots) on 8 of its synthetic trees, on the card, against
    :func:`tree_definition`: (the largest error beyond F32_TOL's rtol,
    the failed checks)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.examples import treelstm_sentiment as ts
    parsed = ts._synthetic_trees(8, 2000, 128, seed=0)
    _, children, leaf_ids, _ = ts.trees_to_arrays(
        parsed, ts.vocabulary(parsed, 2000), 128, 64)
    model = nn.BinaryTreeLSTM(64, 64, generator=torch.Generator()
                              .manual_seed(4), device=device)
    x = np.random.default_rng(4).standard_normal((8, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        got = model((torch.tensor(x, device=device),
                     torch.tensor(children, device=device),
                     torch.tensor(leaf_ids, device=device))).cpu().numpy()
    want = tree_definition(model, x, children, leaf_ids)
    excess = float((np.abs(got - want) - F32_TOL["rtol"] * np.abs(want))
                   .max())
    failed = [] if excess <= F32_TOL["atol"] else [
        f"BinaryTreeLSTM: the states are {excess:.3e} beyond rtol "
        f"{F32_TOL['rtol']} of the definition's (atol {F32_TOL['atol']})"]
    return excess, failed


def example_args(name, n, epochs, device):
    from bigdl_tpu_torch.examples import text_classifier, treelstm_sentiment
    module = text_classifier if name == "text_classifier" \
        else treelstm_sentiment
    return module, module.parse_args(["--synthetic", str(n), "-e",
                                      str(epochs), "-q", "--device", device])


def example_run(name, k, device="cuda"):
    """One example trained at its defaults, windows of ``k`` (1: eager),
    the wrappers' counts zeroed before and read after; samples/s and ms
    a step from the steady windows, peak memory."""
    module, args = example_args(
        name, TEXT_N if name == "text_classifier" else TREE_N,
        EXAMPLE_EPOCHS, device)
    _free()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    model, opt = module.train(args, configure=dispatch_of(k))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steady = opt.window_timings[1:]
    steps = sum(n for n, _, _ in steady)
    return dict(model=model, opt=opt, wall=wall, launches=_read_counts(),
                peak=torch.cuda.max_memory_allocated(),
                samples_per_s=_samples_per_s(opt, args.batch_size),
                ms_per_step=sum(dt for _, dt, _ in steady) / steps * 1e3,
                losses=[v for _, v in opt.loss_history],
                dispatch=dict(opt.dispatch_stats),
                validation=[{n: v.result()[0] for n, v in res.items()}
                            for _, res in opt.validation_history])


def example_busy(name, device="cuda"):
    """The device's busy ms a step over a short run of the example
    (EXAMPLE_BUSY_N samples, one epoch, no validation, windows of
    EXAMPLE_WINDOW) under traced()."""
    module, args = example_args(name, EXAMPLE_BUSY_N[name], 1, device)

    def configure(opt):
        opt.set_iterations_per_dispatch(EXAMPLE_WINDOW)
        opt.val_trigger = None
    (_, opt), framed = traced_call(lambda: module.train(args, configure))
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(framed))
    return busy_us / device_steps(opt, opt.state["neval"] - 1) / 1e3


def layers_9c_reading(device="cuda") -> dict:
    """The layers_9c phase's readings and failed checks: TF32 off, every
    layer of LAYERS_9C on the card against a CPU copy, then each example
    eagerly and in windows of EXAMPLE_WINDOW under deterministic
    algorithms (losses and parameters bit for bit; the loss finite and
    falling), none launching #1-#11."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    failed, layers = [], {}
    _zero_counts()
    for name, make, shapes, pack in LAYERS_9C:
        layers[name], bad = layer_case(name, make, shapes, pack, device)
        failed += bad
    tree_excess, bad = tree_held(device)
    failed += bad
    launches = {"layers_9c": _read_counts()}
    examples = {}
    for name in ("text_classifier", "treelstm"):
        with deterministic() as nondet:
            runs = {"eager": example_run(name, 1, device),
                    "graph": example_run(name, EXAMPLE_WINDOW, device)}
        for label, x in runs.items():
            launches[f"{name}_{label}_training"] = x["launches"]
            losses = x["losses"]
            if not (np.all(np.isfinite(losses)) and
                    np.mean(losses[-4:]) < np.mean(losses[:4])):
                failed.append(f"{name} {label}: the loss did not fall: "
                              f"{losses[:4]} ... {losses[-4:]}")
        e, g = runs["eager"], runs["graph"]
        same_losses = e["opt"].loss_history == g["opt"].loss_history
        same_params = all(torch.equal(p, q) for p, q in zip(
            e["model"].parameters(), g["model"].parameters()))
        if not (same_losses and same_params):
            failed.append(f"{name}: windows of {EXAMPLE_WINDOW} are not the "
                          f"eager run (losses {'equal' if same_losses else 'differ'}, "
                          f"parameters {'equal' if same_params else 'differ'})")
        if not g["dispatch"].get("replays"):
            failed.append(f"{name}: the windowed run replayed no graph: "
                          f"{g['dispatch']}")
        for x in runs.values():
            del x["opt"], x["model"]
        _free()
        # the eager steps launch the windows' kernels: one trace serves
        runs["eager"]["busy"] = runs["graph"]["busy"] = example_busy(
            name, device)
        examples[name] = dict(runs=runs, same_losses=same_losses,
                              same_params=same_params,
                              nondeterministic=sorted(nondet))
    for path, counts in launches.items():
        if any(counts.values()):
            failed.append(f"{path} launched a kernel of #1-#11: {counts}")
    return dict(layers=layers, tree_excess=tree_excess, examples=examples,
                launches=launches, seconds=time.perf_counter() - t0,
                failed=failed)


def phase_layers_9c(smi):
    """13j: see layers_9c_reading."""
    def report(r):
        worst = max(r["layers"].items(), key=lambda kv: kv[1])
        print(f"layers_9c: {len(r['layers'])} layers forward and backward "
              f"on the card against a CPU copy (TF32 off): all within "
              f"rtol {LAYER_TOL['rtol']}, atol {LAYER_TOL['atol']}; the "
              f"largest excess over rtol {worst[1]:.3e} ({worst[0]}); "
              f"BinaryTreeLSTM on 8 synthetic trees against the node-by-node "
              f"definition: largest excess {r['tree_excess']:.3e}",
              flush=True)
        for name, ex in r["examples"].items():
            for label, x in ex["runs"].items():
                step = x["ms_per_step"]
                print(f"layers_9c: {name} {label}: {x['samples_per_s']:.1f} "
                      f"samples/s, {step:.3f} ms a step (steady windows), "
                      f"{x['wall']:.2f} s with validation; device busy "
                      f"{x['busy']:.3f} ms a step (torch.profiler, a short "
                      f"run in windows), idle share "
                      f"{1 - x['busy'] / step:.3f}; peak "
                      f"memory {x['peak']} bytes; loss {x['losses'][0]:.5f} "
                      f"-> {x['losses'][-1]:.5f} over {len(x['losses'])} "
                      f"steps; validation {x['validation']}; dispatch "
                      f"{x['dispatch']}", flush=True)
            print(f"layers_9c: {name}: windows of {EXAMPLE_WINDOW} against "
                  f"eager: losses {'equal' if ex['same_losses'] else 'DIFFER'}"
                  f", parameters {'equal' if ex['same_params'] else 'DIFFER'}"
                  f" bit for bit; operations without a deterministic "
                  f"implementation: {ex['nondeterministic'] or 'none'}",
                  flush=True)
        print(f"layers_9c: launches of #1-#11 by path "
              f"{ {p: sum(c.values()) for p, c in r['launches'].items()} }; "
              f"{r['seconds']:.1f} s; on {smi}", flush=True)
    return _phase("layers_9c", layers_9c_reading, report)


# ---------------------------------------------------------------------------
# 13k. recommender: WideAndDeep at the id stream's 100M-user scale
# ---------------------------------------------------------------------------

# synthetic_id_stream's defaults (bigdl_tpu/dataset/movielens.py:74-76):
# 100M users, 1M items, batches of 4096; REC_BATCHES of them (seed 0) for
# REC_EPOCHS epochs, eagerly and in windows of REC_WINDOW; wide_and_deep's
# widths (embed 16, tower (32, 16): bigdl_tpu/models/dlrm.py:77-83); the
# tables on SGD(0.5) and the tower on SGD(0.05), docs/recommender.md's
# example
REC_USERS, REC_ITEMS, REC_BATCH, REC_BATCHES = (100_000_000, 1_000_000,
                                                4096, 16)
REC_EPOCHS, REC_WINDOW = 4, 4
REC_TABLE_LR, REC_DENSE_LR = 0.5, 0.05
# eval: HitRatio@10 and NDCG@10 over slates of 1 positive + 100 negatives
# (the ncf example's --neg-eval 100: bigdl_tpu/examples/ncf.py:77) for
# REC_EVAL_USERS of the stream's positive pairs, REC_EVAL_BATCH slates a
# batch, stopped after REC_EVAL_STOP batches and resumed
REC_EVAL_USERS, REC_EVAL_NEG, REC_EVAL_BATCH, REC_EVAL_STOP = (4096, 100,
                                                               256, 3)
# scoring: REC_REQUESTS pairs through RecommenderScorer, each with the
# session key of its user's shard among REC_SHARDS
REC_REQUESTS, REC_SHARDS = 64, 8
# the card against a CPU copy at MovieLens-1M's widths (6040 users, 3706
# items, batch 256: the ncf example's shape), REC_CPU_STEPS steps, TF32
# off: each loss within REC_LOSS_RTOL, each parameter within
# REC_PARAM_NORM_REL in norm; the CPU's float32 run is held to the same
# bounds against its float64 run first (queue 3: the inputs are
# conditioned where f32 and f64 part)
REC_CPU_USERS, REC_CPU_ITEMS, REC_CPU_BATCH, REC_CPU_STEPS = 6040, 3706, \
    256, 10
REC_LOSS_RTOL, REC_PARAM_NORM_REL = 1e-5, 1e-5
# the short traced runs (eager, and in windows of REC_WINDOW) whose device
# time gives each run's busy and idle shares
REC_BUSY_BATCHES = 8


def rec_batches(users=None, items=None, batch=None, batches=None, seed=0):
    """The id stream's (pairs [B, 2] int32, labels [B, 1]) batches, by
    default REC_BATCHES of REC_BATCH over REC_USERS x REC_ITEMS."""
    from bigdl_tpu_torch.dataset.movielens import synthetic_id_stream
    return list(synthetic_id_stream(
        users or REC_USERS, items or REC_ITEMS, batch or REC_BATCH,
        batches or REC_BATCHES, seed))


def rec_dataset(batches, device="cuda"):
    """The batches as an unshuffled DataSet, cached on the card."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    data = DataSet.array([MiniBatch(p, y) for p, y in batches],
                         shuffle=False)
    return data if device == "cpu" else data.cache_on_device(device)


def rec_model(device="cuda", users=None, items=None, seed=0):
    """``zoo("wide_and_deep")`` at the builder's widths (by default over
    REC_USERS x REC_ITEMS), drawn from a seeded generator on ``device``
    (the tables on the card)."""
    from bigdl_tpu_torch.models import zoo
    g = torch.Generator(device=device).manual_seed(seed)
    return zoo("wide_and_deep", user_count=users or REC_USERS,
               item_count=items or REC_ITEMS, generator=g, device=device)


def rec_optimizer(model, data, k=1, epochs=None, iterations=None):
    """BCE, the tables and the tower on their own SGD
    (``hybrid_optim_methods``), windows of ``k``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.embedding import hybrid_optim_methods
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    end = (Trigger.max_iteration(iterations) if iterations
           else Trigger.max_epoch(epochs or REC_EPOCHS))
    return (Optimizer(model, data, nn.BCECriterion(), seed=0)
            .set_optim_methods(hybrid_optim_methods(
                model, SGD(REC_TABLE_LR), SGD(REC_DENSE_LR)))
            .set_end_when(end).set_iterations_per_dispatch(k))


@contextmanager
def scatter_rows_recorded():
    """For each ``dedup_gather`` backward in the block: (its table's
    width, the unique 0-based ids it was given, the ids whose row its
    scatter lands nonzero)."""
    from bigdl_tpu_torch.nn import sparse
    inner = sparse.dedup_scatter_updates
    seen = []

    def recorded(idx, grads):
        rows, contrib = inner(idx, grads)
        landed = rows[(contrib != 0).flatten(1).any(1)]
        seen.append((int(grads[0].numel()), torch.unique(idx), landed))
        return rows, contrib
    sparse.dedup_scatter_updates = recorded
    try:
        yield seen
    finally:
        sparse.dedup_scatter_updates = inner


@contextmanager
def tower_forwards(model):
    """For each forward of ``model`` (a WideAndDeep) in the block: [its
    pairs, the outputs of the tower's ReLU layers]."""
    from bigdl_tpu_torch import nn
    seen = []

    def pairs_in(module, args):
        seen.append([torch.as_tensor(args[0]), []])

    def relu_out(module, args, out):
        seen[-1][1].append(out.detach())
    handles = [model.register_forward_pre_hook(pairs_in)] + [
        m.register_forward_hook(relu_out) for m in model.tower
        if isinstance(m, nn.ReLU)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def rec_step_check(device="cuda"):
    """One Optimizer step of the model on the stream's first batch.  Each
    table's scatter lands at most one row per unique id.  The user
    tables' nonzero gradient rows are, in number and position, the
    batch's unique users: all of them for ``wide_user``; for
    ``user_table`` all but the users each of whose samples has some ReLU
    layer of the tower off in every unit (read from the forward by hooks,
    so no gradient can reach their rows).  No row the batch did not touch
    moves in the SGD step.  (readings, failed)."""
    model = rec_model(device)
    batches = rec_batches(batches=1)
    pairs = batches[0][0]
    users = torch.as_tensor(np.unique(pairs[:, 0]) - 1,
                            device=device).long()
    touched = torch.zeros(REC_USERS, dtype=torch.bool, device=device)
    touched[users] = True
    before = {n: getattr(model, n).weight.detach().clone()
              for n in ("user_table", "wide_user")}
    opt = rec_optimizer(model, rec_dataset(batches, device), iterations=1)
    _zero_counts()
    with scatter_rows_recorded() as scattered, \
            tower_forwards(model) as forwards:
        opt.optimize()
    launches = _read_counts()
    failed, rows = [], {}
    landed_rows = [(dim, len(uniq), len(landed))
                   for dim, uniq, landed in scattered]
    if len(scattered) != 4 or any(n > u for _, u, n in landed_rows):
        failed.append(f"the tables' scatters landed (width, unique ids, "
                      f"rows) {landed_rows}: more than one row per unique "
                      f"id")
    live = torch.zeros_like(touched)
    if len(forwards) == 1:
        seen, relus = forwards[0]
        dead = torch.stack([(r == 0).all(-1) for r in relus]).any(0)
        live[seen[..., 0].to(device)[~dead.to(device)].long() - 1] = True
    else:
        failed.append(f"the step ran {len(forwards)} forwards, not one")
    for n, want in (("user_table", live), ("wide_user", touched)):
        w = getattr(model, n).weight
        nonzero = (w.grad != 0).any(1)
        moved = (w.detach() != before[n]).any(1)
        rows[n] = dict(nonzero_grad_rows=int(nonzero.sum()),
                       zero_updates=int((touched & ~nonzero).sum()),
                       tower_off_users=int((touched & ~want).sum()),
                       untouched_moved=int((moved & ~touched).sum()),
                       touched_moved=int((moved & touched).sum()))
        if not torch.equal(nonzero, want):
            failed.append(f"{n}: {rows[n]['nonzero_grad_rows']} nonzero "
                          f"gradient rows, not the batch's {len(users)} "
                          f"unique users less the "
                          f"{rows[n]['tower_off_users']} whose tower is off"
                          f" ({int((nonzero & ~want).sum())} rows beyond "
                          f"them, {int((want & ~nonzero).sum())} missing)")
        if rows[n]["untouched_moved"]:
            failed.append(f"{n}: {rows[n]['untouched_moved']} rows the "
                          f"batch did not touch moved in the SGD step")
    reading = dict(unique_users=len(users),
                   unique_items=int(np.unique(pairs[:, 1]).size),
                   tables=rows, scattered=landed_rows, launches=launches,
                   loss=opt.loss_history[-1][1])
    del model, before, opt, touched, live, scattered, forwards
    _free()
    return reading, failed


def rec_train(k, device="cuda", batches=None):
    """The model trained REC_EPOCHS epochs over ``batches`` in windows of
    ``k`` (1: eagerly), the wrappers' counts zeroed before and read
    after: the model, its optimizer, ms a step and samples/s of the
    steady windows, peak memory."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    model = rec_model(device)
    opt = rec_optimizer(model, rec_dataset(batches or rec_batches(),
                                           device), k=k)
    _zero_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steady = opt.window_timings[1:]
    steps = sum(n for n, _, _ in steady)
    return dict(model=model, opt=opt, wall=wall, launches=_read_counts(),
                peak=torch.cuda.max_memory_allocated(),
                ms_per_step=sum(dt for _, dt, _ in steady) / steps * 1e3,
                samples_per_s=_samples_per_s(opt, REC_BATCH),
                losses=[v for _, v in opt.loss_history],
                dispatch=dict(opt.dispatch_stats))


def rec_slates(batches, seed=1):
    """[REC_EVAL_USERS, 1 + REC_EVAL_NEG, 2] slates: the stream's first
    positive pairs, each followed by negatives drawn at random from the
    REC_ITEMS items for its user."""
    pos = np.concatenate([p[y[:, 0] > 0] for p, y in batches])
    pos = pos[:REC_EVAL_USERS]
    slates = np.empty((len(pos), 1 + REC_EVAL_NEG, 2), np.int32)
    slates[:, :, 0] = pos[:, :1]
    slates[:, 0, 1] = pos[:, 1]
    slates[:, 1:, 1] = np.random.default_rng(seed).integers(
        1, REC_ITEMS + 1, size=(len(pos), REC_EVAL_NEG))
    return slates


def rec_eval(model, slates, device="cuda"):
    """StreamingRecEval's one-shot sweep, and the same sweep stopped after
    REC_EVAL_STOP batches, its state round-tripped through JSON and
    resumed: results and partial sums equal bit for bit.  (readings,
    failed)."""
    from bigdl_tpu_torch.embedding import StreamingRecEval

    def evaluator():
        return StreamingRecEval(model, batch_size=REC_EVAL_BATCH,
                                device=device)
    oneshot, final = evaluator().evaluate(slates)
    _, state = evaluator().evaluate(slates, max_batches=REC_EVAL_STOP)
    state = json.loads(json.dumps(state))
    resumed, resumed_final = evaluator().evaluate(slates, state=state)
    failed = []
    got = None if resumed is None else [r.result() for r in resumed]
    want = [r.result() for r in oneshot]
    if got != want or resumed_final["partials"] != final["partials"]:
        failed.append(f"eval: resumed after {REC_EVAL_STOP} batches "
                      f"{got} {resumed_final['partials']}, one-shot {want} "
                      f"{final['partials']}")
    if not all(0.0 <= v <= 1.0 for v, _ in want):
        failed.append(f"eval: results out of [0, 1]: {want}")
    return dict(results={r.fmt: r.result()[0] for r in oneshot},
                chance=_chance(10, REC_EVAL_NEG), slates=len(slates),
                partials=final["partials"]), failed


def rec_scoring(model, pairs, device="cuda"):
    """REC_REQUESTS pairs through RecommenderScorer, each with the session
    key of its user's shard: every scored row within F32_TOL of the
    model's forward of the row alone.  (readings, failed)."""
    from bigdl_tpu_torch.embedding import (RecommenderScorer,
                                           shard_affinity_key)
    rows = pairs[:REC_REQUESTS]
    sessions = [shard_affinity_key(int(u), REC_USERS, REC_SHARDS,
                                   model="wide_and_deep") for u in rows[:, 0]]
    scorer = RecommenderScorer(model, max_batch=32, device=device).warmup(
        np.zeros(2, np.int32))
    futures = [scorer.submit_generate_async(r, 1) for r in rows]
    scores = [np.asarray(f.result(120)) for f in futures]
    stats = scorer.stats()
    scorer.shutdown()
    failed, worst = [], 0.0
    with torch.inference_mode():
        for i, (r, got) in enumerate(zip(rows, scores)):
            want = model(torch.as_tensor(r[None], device=device))[0].cpu() \
                .numpy()
            worst = max(worst, float(np.abs(got - want).max()))
            if got.shape != want.shape or not np.allclose(got, want,
                                                          **F32_TOL):
                failed.append(f"scoring: request {i} scored {got}, its "
                              f"solo forward {want}")
    return dict(requests=len(rows), max_abs_err=worst,
                shards=len(set(sessions)),
                sessions=sorted(set(sessions))[:4], stats=stats), failed


def rec_parity(device="cuda"):
    """REC_CPU_STEPS steps at MovieLens-1M's widths on the card against a
    CPU copy, and the CPU's float32 run against its float64 run, by
    REC_LOSS_RTOL and REC_PARAM_NORM_REL.  (readings, failed)."""
    import copy
    batches = rec_batches(REC_CPU_USERS, REC_CPU_ITEMS, REC_CPU_BATCH,
                          REC_CPU_STEPS, seed=1)
    cpu = rec_model("cpu", REC_CPU_USERS, REC_CPU_ITEMS, seed=1)
    runs = {}
    for name, m, dev, data in (
            ("cpu", cpu, "cpu", batches),
            ("f64", copy.deepcopy(cpu).double(), "cpu",
             [(p, y.astype(np.float64)) for p, y in batches]),
            ("card", _copy_to(cpu, device), device, batches)):
        opt = rec_optimizer(m, rec_dataset(data, dev),
                            iterations=REC_CPU_STEPS)
        opt.optimize()
        runs[name] = (np.asarray([v for _, v in opt.loss_history]),
                      [p.detach().cpu().double() for p in m.parameters()])
    gaps, failed = {}, []
    for name, other in (("f32_vs_f64", "f64"), ("card_vs_cpu", "card")):
        (a, pa), (b, pb) = runs[other], runs["cpu"]
        gaps[name] = dict(
            loss_rel=float(np.max(np.abs(a - b) / np.abs(b))),
            param_norm_rel=max(float((p - q).norm() / q.norm())
                               for p, q in zip(pa, pb)))
        if not (gaps[name]["loss_rel"] <= REC_LOSS_RTOL and
                gaps[name]["param_norm_rel"] <= REC_PARAM_NORM_REL):
            failed.append(f"{name}: loss {gaps[name]['loss_rel']:.3e}, "
                          f"parameters {gaps[name]['param_norm_rel']:.3e} "
                          f"in norm (bounds {REC_LOSS_RTOL}, "
                          f"{REC_PARAM_NORM_REL})")
    gaps["losses"] = [round(float(v), 6) for v in runs["card"][0]]
    return gaps, failed


def rec_busy(model, batches, k, device="cuda"):
    """The device's busy ms a step over REC_BUSY_BATCHES steps of
    ``model`` in windows of ``k`` (1: eagerly) under traced()."""
    def run():
        opt = rec_optimizer(model, rec_dataset(batches[:REC_BUSY_BATCHES],
                                               device), k=k, epochs=1)
        opt.optimize()
        return opt
    opt, framed = traced_call(run)
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(framed))
    return busy_us / device_steps(opt, REC_BUSY_BATCHES) / 1e3


def recommender_reading(device="cuda") -> dict:
    """The recommender phase's readings and failed checks: TF32 off; the
    step check (rec_step_check), 64 steps eagerly and in windows of
    REC_WINDOW under deterministic algorithms (losses and parameters bit
    for bit; the loss finite, the last epoch's mean below the first's),
    the eval resume (rec_eval) and the scoring (rec_scoring) on the
    trained model, the busy share of each run (rec_busy) and the card
    against a CPU copy (rec_parity); none launching #1-#11."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    batches = rec_batches()
    unique = [(np.unique(p[:, 0]).size, np.unique(p[:, 1]).size)
              for p, _ in batches]
    check, failed = rec_step_check(device)
    launches = {"recommender_step_check": check.pop("launches")}
    with deterministic() as nondet:
        eager = rec_train(1, device, batches)
        eager_params = [p.detach().cpu() for p in eager["model"].parameters()]
        eager_history = eager["opt"].loss_history
        del eager["model"], eager["opt"]
        graph = rec_train(REC_WINDOW, device, batches)
    model = graph.pop("model")
    model.zero_grad(set_to_none=True)
    same_losses = graph.pop("opt").loss_history == eager_history
    same_params = all(torch.equal(a, p.detach().cpu()) for a, p in
                      zip(eager_params, model.parameters()))
    del eager_params
    runs = {"eager": eager, "graph": graph}
    for label, x in runs.items():
        launches[f"recommender_{label}_training"] = x.pop("launches")
        losses = np.asarray(x["losses"])
        first = losses[:REC_BATCHES].mean()
        last = losses[-REC_BATCHES:].mean()
        x["epoch_means"] = (float(first), float(last))
        if not (np.all(np.isfinite(losses))
                and len(losses) == REC_BATCHES * REC_EPOCHS and last < first):
            failed.append(f"{label}: the loss did not fall over "
                          f"{len(losses)} steps: epoch means {first} -> "
                          f"{last}")
    if not (same_losses and same_params):
        failed.append(f"windows of {REC_WINDOW} are not the eager run "
                      f"(losses {'equal' if same_losses else 'differ'}, "
                      f"parameters {'equal' if same_params else 'differ'})")
    want = REC_BATCHES * REC_EPOCHS
    if graph["dispatch"].get("replays") != want:
        failed.append(f"the windowed run replayed {graph['dispatch']}, not "
                      f"{want} steps")
    _zero_counts()
    evaluation, bad = rec_eval(model, rec_slates(batches), device)
    failed += bad
    scoring, bad = rec_scoring(model, batches[0][0], device)
    failed += bad
    launches["recommender_eval_and_scoring"] = _read_counts()
    _zero_counts()
    busy = {label: rec_busy(model, batches, k, device)
            for label, k in (("eager", 1), ("graph", REC_WINDOW))}
    launches["recommender_busy"] = _read_counts()
    del model
    _free()
    _zero_counts()
    parity, bad = rec_parity(device)
    failed += bad
    launches["recommender_cpu_parity"] = _read_counts()
    for path, counts in launches.items():
        if any(counts.values()):
            failed.append(f"{path} launched a kernel of #1-#11: {counts}")
    return dict(check=check, unique=unique, runs=runs, busy=busy,
                same_losses=same_losses, same_params=same_params,
                nondeterministic=sorted(nondet), evaluation=evaluation,
                scoring=scoring, parity=parity, launches=launches,
                seconds=time.perf_counter() - t0, failed=failed)


def phase_recommender(smi):
    """13k: see recommender_reading."""
    def report(r):
        c = r["check"]
        u = np.asarray(r["unique"])
        print(f"recommender: wide_and_deep at {REC_USERS} users x "
              f"{REC_ITEMS} items (embed 16, tower (32, 16)), batches of "
              f"{REC_BATCH}: unique users a batch {u[:, 0].min()}-"
              f"{u[:, 0].max()}, unique items {u[:, 1].min()}-"
              f"{u[:, 1].max()}; one step: {c['tables']}, the scatters' "
              f"(width, unique ids, rows landed) {c['scattered']}",
              flush=True)
        for label, x in r["runs"].items():
            step = x["ms_per_step"]
            print(f"recommender: {label}: {step:.3f} ms a step, "
                  f"{x['samples_per_s']:.1f} samples/s (steady windows), "
                  f"{x['wall']:.2f} s for {len(x['losses'])} steps; device "
                  f"busy {r['busy'][label]:.3f} ms a step (torch.profiler, "
                  f"{REC_BUSY_BATCHES} steps run the same way), idle share "
                  f"{1 - r['busy'][label] / step:.3f}; peak memory "
                  f"{x['peak']} bytes; epoch mean loss "
                  f"{x['epoch_means'][0]:.5f} -> {x['epoch_means'][1]:.5f}"
                  f"; dispatch {x['dispatch']}", flush=True)
        print(f"recommender: windows of {REC_WINDOW} against eager: losses "
              f"{'equal' if r['same_losses'] else 'DIFFER'}, parameters "
              f"{'equal' if r['same_params'] else 'DIFFER'} bit for bit; "
              f"operations without a deterministic implementation: "
              f"{r['nondeterministic'] or 'none'}", flush=True)
        e, s, p = r["evaluation"], r["scoring"], r["parity"]
        print(f"recommender: eval {e['results']} over {e['slates']} slates "
              f"of 1 + {REC_EVAL_NEG} (chance {e['chance']}), resumed "
              f"after {REC_EVAL_STOP} batches equal to the one-shot sweep; "
              f"scoring {s['requests']} requests over {s['shards']} shard "
              f"sessions, largest error against the solo forward "
              f"{s['max_abs_err']:.3e}; "
              f"card against CPU at MovieLens-1M widths {p['card_vs_cpu']},"
              f" CPU f32 against f64 {p['f32_vs_f64']}", flush=True)
        print(f"recommender: launches of #1-#11 by path "
              f"{ {k: sum(v.values()) for k, v in r['launches'].items()} }; "
              f"{r['seconds']:.1f} s; on {smi}", flush=True)
    return _phase("recommender", recommender_reading, report)


# ---------------------------------------------------------------------------
# 13l. ops_9b: nn/sparse.py, ops/operations.py and ops/control.py on the
# card against the CPU
# ---------------------------------------------------------------------------

# every op of ops/operations.py on the same numpy inputs on the card and
# on the CPU: a floating result within OPS_TOL (the card's special
# functions are some ulps from the host's), any other equal; the edge
# cases also equal their numpy definition (the reference's semantics)
OPS_TOL = dict(rtol=1e-5, atol=1e-6)
# ops over numpy object arrays (strings), which run on the host; every
# other op's results from card inputs must lie on the card
HOST_OPS = ("Substr",)


def _ops_arrays():
    rng = np.random.default_rng(9)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return dict(
        halves=np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7, -3.7, 0.0],
                          np.float32),
        ia=np.asarray([7, -7, 7, -7, 6, -6, 0, 1], np.int32),
        ib=np.asarray([2, 2, -2, -2, 3, 4, 3, -5], np.int32),
        fa=np.asarray([7.5, -7.5, 7.5, -7.5, 6.0, -0.25, 0.0, 1e-3],
                      np.float32),
        fb=np.asarray([2.0, 2.0, -2.0, -2.0, 3.0, 4.0, 3.0, -5.0],
                      np.float32),
        x=r(3, 4), pos=np.abs(r(7)) + 0.25, r=r,
        specials=np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32),
        ties=(np.arange(4096) % 4).astype(np.float32).reshape(2, 2048))


def _trunc_div(a, b):
    return (np.abs(a) // np.abs(b)) * np.sign(a) * np.sign(b)


def _one_hot(idx, depth, on, off):
    hot = (idx[..., None] == np.arange(depth))
    return np.where(hot, on, off)


def _stable_top(x, k):
    order = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return [np.take_along_axis(x, order, -1), order]


def _gather_fill(params, idx):
    n = params.shape[0]
    idx = np.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return np.where(ok[:, None], params[np.clip(idx, 0, n - 1)], 0)


def _in_top_k(pred, target, k):
    score = pred[np.arange(len(target)), target]
    return np.isfinite(score) & ((pred > score[:, None]).sum(1) < k)


def ops_cases():
    """(name, make(ops, nn, device), input (numpy, nested), numpy definition
    of the result or None): every class of ops/operations.py but the random ops
    (random_ops_held)."""
    a = _ops_arrays()
    r, x, pos = a["r"], a["x"], a["pos"]
    ia, ib, fa, fb = a["ia"], a["ib"], a["fa"], a["fb"]
    tie_rows = np.asarray([[0.5, 0.5, 0.5, 0.1], [0.9, 0.2, 0.2, 0.2],
                           [np.nan, 0.5, 0.1, 0.0]], np.float32)
    params = r(3, 2)
    gidx = np.asarray([2, -1, 0, 3, -4, 1], np.int32)
    bounds = [10.0, 0.0, 100.0]
    bx = np.asarray([-5.0, 0.0, 5.0, 10.0, 50.0, 100.0, 500.0], np.float32)
    return [
        ("All", lambda o, n, d: o.All(), (x > -1, 0), None),
        ("Any", lambda o, n, d: o.Any(keep_dims=True), (x > 1, 1), None),
        ("ArgMax", lambda o, n, d: o.ArgMax(1),
         np.asarray([[1, 3, 3], [2, 2, 1]], np.float32),
         np.asarray([1, 0])),
        ("BatchMatMul", lambda o, n, d: o.BatchMatMul(True, True),
         (r(2, 4, 3), r(2, 5, 4)), None),
        ("Cast", lambda o, n, d: o.Cast(np.int32), a["halves"] * 1.3,
         (a["halves"] * 1.3).astype(np.int32)),
        ("Ceil", lambda o, n, d: o.Ceil(), a["halves"], np.ceil(a["halves"])),
        ("Floor", lambda o, n, d: o.Floor(), a["halves"],
         np.floor(a["halves"])),
        ("Round", lambda o, n, d: o.Round(), a["halves"],
         np.round(a["halves"])),
        ("Rint", lambda o, n, d: o.Rint(), a["halves"], np.rint(a["halves"])),
        ("Equal", lambda o, n, d: o.Equal(), (ia, ib), ia == ib),
        ("NotEqual", lambda o, n, d: o.NotEqual(), (ia, ib), ia != ib),
        ("Greater", lambda o, n, d: o.Greater(), (ia, ib), ia > ib),
        ("GreaterEqual", lambda o, n, d: o.GreaterEqual(), (ia, ib), ia >= ib),
        ("Less", lambda o, n, d: o.Less(), (ia, ib), ia < ib),
        ("LessEqual", lambda o, n, d: o.LessEqual(), (fa, fb), fa <= fb),
        ("Erf", lambda o, n, d: o.Erf(), x * 2, None),
        ("Erfc", lambda o, n, d: o.Erfc(), x * 2, None),
        ("Expm1", lambda o, n, d: o.Expm1(), x, None),
        ("FloorDiv_int", lambda o, n, d: o.FloorDiv(), (ia, ib),
         np.floor_divide(ia, ib)),
        ("FloorDiv_float", lambda o, n, d: o.FloorDiv(), (fa, fb),
         np.floor_divide(fa, fb)),
        ("FloorMod_int", lambda o, n, d: o.FloorMod(), (ia, ib),
         np.mod(ia, ib)),
        ("FloorMod_float", lambda o, n, d: o.FloorMod(), (fa, fb), None),
        ("Mod_int", lambda o, n, d: o.Mod(), (ia, ib), np.fmod(ia, ib)),
        ("Mod_float", lambda o, n, d: o.Mod(), (fa, fb), np.fmod(fa, fb)),
        ("TruncateDiv_int", lambda o, n, d: o.TruncateDiv(), (ia, ib),
         _trunc_div(ia, ib)),
        ("TruncateDiv_float", lambda o, n, d: o.TruncateDiv(), (fa, fb),
         np.trunc(fa / fb)),
        ("Inv", lambda o, n, d: o.Inv(), pos, None),
        ("IsFinite", lambda o, n, d: o.IsFinite(), a["specials"],
         np.isfinite(a["specials"])),
        ("IsInf", lambda o, n, d: o.IsInf(), a["specials"],
         np.isinf(a["specials"])),
        ("IsNan", lambda o, n, d: o.IsNan(), a["specials"],
         np.isnan(a["specials"])),
        ("L2Loss", lambda o, n, d: o.L2Loss(), x, None),
        ("Lgamma", lambda o, n, d: o.Lgamma(), pos * 3, None),
        ("Digamma", lambda o, n, d: o.Digamma(), pos * 3, None),
        ("Log1p", lambda o, n, d: o.Log1p(), pos, None),
        ("LogicalAnd", lambda o, n, d: o.LogicalAnd(), (x > 0, x > 0.5),
         (x > 0) & (x > 0.5)),
        ("LogicalOr", lambda o, n, d: o.LogicalOr(), (x > 0, x < -0.5),
         (x > 0) | (x < -0.5)),
        ("LogicalNot", lambda o, n, d: o.LogicalNot(), x > 0, ~(x > 0)),
        ("MaximumOp", lambda o, n, d: o.MaximumOp(), (fa, fb),
         np.maximum(fa, fb)),
        ("MinimumOp", lambda o, n, d: o.MinimumOp(), (ia, ib),
         np.minimum(ia, ib)),
        ("OneHot", lambda o, n, d: o.OneHot(),
         (np.asarray([-1, 0, 2, 5], np.int32), 3, 5.0, -1.0),
         _one_hot(np.asarray([-1, 0, 2, 5]), 3, 5.0, -1.0)),
        ("Pad", lambda o, n, d: o.Pad("REFLECT"),
         (r(3, 4, 5), [[1, 2], [2, 1], [0, 3]]), None),
        ("Pad_symmetric", lambda o, n, d: o.Pad("SYMMETRIC"),
         (x, [[3, 1], [2, 4]]), np.pad(x, [[3, 1], [2, 4]], "symmetric")),
        ("Pow", lambda o, n, d: o.Pow(), (pos, r(7)), None),
        ("Prod", lambda o, n, d: o.Prod(axis=1, keep_dims=True), x, None),
        ("RangeOps", lambda o, n, d: o.RangeOps(device=d), (0.5, 3.0, 0.75),
         np.arange(0.5, 3.0, 0.75)),
        ("Rank", lambda o, n, d: o.Rank(), r(2, 3, 4), np.asarray(3)),
        ("Rsqrt", lambda o, n, d: o.Rsqrt(), pos, None),
        ("SelectOp", lambda o, n, d: o.SelectOp(), (x > 0, x, -x),
         np.where(x > 0, x, -x)),
        ("Sign", lambda o, n, d: o.Sign(),
         np.asarray([-2.0, -0.0, 0.0, 3.0, np.nan], np.float32),
         np.sign(np.asarray([-2.0, -0.0, 0.0, 3.0, np.nan], np.float32))),
        ("Slice", lambda o, n, d: o.Slice((0, 1, 0), (2, 2, -1)), r(2, 3, 4),
         None),
        ("SquaredDifference", lambda o, n, d: o.SquaredDifference(), (fa, fb),
         None),
        ("SumOp", lambda o, n, d: o.SumOp(), (r(2, 3, 4), [0, 2]), None),
        ("TileOp", lambda o, n, d: o.TileOp(), (r(3), [2, 2]), None),
        ("TopK", lambda o, n, d: o.TopK(3),
         np.asarray([[1.0, 5.0, 3.0, 5.0, 3.0], [2.0, 2.0, 2.0, 2.0, 1.0]],
                    np.float32),
         _stable_top(np.asarray([[1.0, 5.0, 3.0, 5.0, 3.0],
                                 [2.0, 2.0, 2.0, 2.0, 1.0]], np.float32), 3)),
        ("TopK_many_ties", lambda o, n, d: o.TopK(16), a["ties"],
         _stable_top(a["ties"], 16)),
        ("BucketizedCol", lambda o, n, d: o.BucketizedCol(bounds), bx,
         np.searchsorted(sorted(bounds), bx, side="right")),
        ("CrossEntropy", lambda o, n, d: o.CrossEntropy(),
         (r(3, 5), np.eye(5, dtype=np.float32)[[1, 4, 0]]), None),
        ("DepthwiseConv2D", lambda o, n, d: o.DepthwiseConv2D(2, 2, "SAME"),
         (r(2, 7, 6, 3), r(3, 3, 3, 2)), None),
        ("TensorOp", lambda o, n, d: ((o.TensorOp() * 2.0 + 2.0).abs().sqrt()
                                   .sigmoid().softmax()
                                   .mean(axis=0, keepdims=True).t()), x,
         None),
        ("ApproximateEqual", lambda o, n, d: o.ApproximateEqual(0.1),
         (np.asarray([1.0, 2.0, 3.0], np.float32),
          np.asarray([1.05, 3.0, 2.95], np.float32)),
         np.asarray([True, False, True])),
        ("Gather", lambda o, n, d: o.Gather(), (params, gidx),
         _gather_fill(params, gidx)),
        ("InTopK", lambda o, n, d: o.InTopK(2),
         (tie_rows, np.asarray([2, 3, 0], np.int32)),
         _in_top_k(tie_rows, np.asarray([2, 3, 0]), 2)),
        ("SegmentSum", lambda o, n, d: o.SegmentSum(num_segments=3),
         (r(5, 2), np.asarray([0, 0, 1, 1, 3], np.int32)), None),
        ("ModuleToOperation", lambda o, n, d: o.ModuleToOperation(n.ReLU()), x,
         np.maximum(x, 0)),
        ("Dilation2D", lambda o, n, d: o.Dilation2D((1, 2, 2, 1), (1, 2, 1, 1),
                                                  "SAME"),
         (r(2, 7, 6, 3), r(2, 3, 3)), None),
        ("Substr", lambda o, n, d: o.Substr(),
         (np.asarray([b"hello", b"world"], object), 1, 3),
         np.asarray([b"ell", b"orl"], object)),
    ]


def _on(v, device):
    if isinstance(v, np.ndarray) and v.dtype != object:
        return torch.tensor(v, device=device)
    if isinstance(v, (tuple, list)):
        return type(v)(_on(a, device) for a in v)
    return v


def _host_list(y):
    ys = list(y) if isinstance(y, (tuple, list)) else [y]
    return [t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in ys]


def ops_held(name, got, want, definition):
    """The failed checks of one op: the card's results against the CPU's
    (OPS_TOL for a floating result, else equal) and its definition."""
    failed = []
    defs = None if definition is None else _host_list(definition)
    for i, (g, w) in enumerate(zip(got, want)):
        ok = g.shape == w.shape and (
            np.allclose(g, w, equal_nan=True, **OPS_TOL)
            if g.dtype.kind == "f" else np.array_equal(g, w))
        if not ok:
            failed.append(f"{name}[{i}]: the card's {g.tolist()} is not the "
                          f"CPU's {w.tolist()}")
        if defs is not None and not (g.shape == defs[i].shape and (
                np.array_equal(g.astype(np.float64),
                               defs[i].astype(np.float64), equal_nan=True)
                if g.dtype != object else g.tolist() == defs[i].tolist())):
            failed.append(f"{name}[{i}]: {g.tolist()} is not its definition "
                          f"{defs[i].tolist()}")
    return failed


def sparse_control_cases():
    """(name, build(nn, ops) -> module, inputs (numpy, nested), int inputs
    by position): the sparse layers and the control-flow modules, forward
    and backward."""
    from bigdl_tpu_torch.nn.sparse import SparseTensor
    rng = np.random.default_rng(11)
    dense = rng.standard_normal((5, 7)).astype(np.float32) * \
        (rng.random((5, 7)) > 0.4)
    idx = np.argwhere(dense != 0).astype(np.int32)
    ids = np.asarray([[r, c] for r in range(4) for c in range(3)], np.int32)

    class Sp(torch.nn.Module):
        """A sparse layer on SparseTensors built from (indices, values)."""

        def __init__(self, inner, shape, weighted=False):
            super().__init__()
            self.inner, self.shape, self.weighted = inner, shape, weighted

        def forward(self, i, v, w=None):
            sp = SparseTensor(i, v, self.shape)
            return self.inner((sp, SparseTensor(i, w, self.shape))
                              if self.weighted else sp)

    class Lam(torch.nn.Module):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn

        def forward(self, v):
            return self.fn(v)

    class Apply(torch.nn.Module):
        """``fn(module, input)``: a control-flow module on its table."""

        def __init__(self, module, fn):
            super().__init__()
            self.module, self.fn = module, fn

        def forward(self, v):
            return self.fn(self.module, v)

    class Cell(torch.nn.Module):
        def __init__(self, nn):
            super().__init__()
            self.lin = nn.Linear(3, 3, **_gen(3))

        def forward(self, sx):
            s2 = torch.tanh(self.lin(sx[0]) + sx[1])
            return s2, s2 * 2.0

    def join(nn):
        class Join(torch.nn.Module):
            def forward(self, i1, v1, i2, v2):
                return nn.SparseJoinTable(2)(
                    [SparseTensor(i1, v1, (5, 7)),
                     SparseTensor(i2, v2, (5, 3))]).to_dense()
        return Join()

    ids_vals = rng.integers(0, 6, size=12).astype(np.float32)
    wts = (rng.random(12) + 0.5).astype(np.float32)
    cases = [
        ("SparseLinear", lambda nn, o: Sp(nn.SparseLinear(7, 3, **_gen(1)),
                                          (5, 7)),
         [idx, dense[tuple(idx.T)]]),
        ("SparseJoinTable", lambda nn, o: join(nn),
         [idx, dense[tuple(idx.T)], idx[:4] % 3, dense[tuple(idx[:4].T)]]),
        ("DenseToSparse", lambda nn, o: Lam(
            lambda v: nn.DenseToSparse()(v).to_dense() * 2.0), [dense]),
        *((f"LookupTableSparse_{c}", (lambda nn, o, c=c: Sp(
            nn.LookupTableSparse(6, 5, combiner=c, max_norm=1.5,
                                 **_gen(2)), (4, 3), weighted=True)),
           [ids, ids_vals, wts]) for c in ("sum", "mean", "sqrtn")),
        ("Cond_true", lambda nn, o: Apply(o.Cond(
            nn.Linear(3, 3, **_gen(4)), nn.Identity()),
            lambda m, v: m((True, v))),
         [rng.standard_normal((2, 3)).astype(np.float32)]),
        ("Cond_tensor", lambda nn, o: Apply(o.Cond(
            nn.Identity(), nn.Tanh()), lambda m, v: m((v.sum() > 1e9, v))),
         [rng.standard_normal((2, 3)).astype(np.float32)]),
        ("WhileLoop", lambda nn, o: Apply(o.WhileLoop(
            lambda s: s[0] < 4, Lam(lambda s: (s[0] + 1, s[1] * 1.5)),
            max_iterations=3),
            lambda m, v: m((torch.zeros((), device=v.device), v))[1]),
         [rng.standard_normal(3).astype(np.float32)]),
        ("Scan", lambda nn, o: Apply(o.Scan(Cell(nn)), lambda m, v: m(
            (torch.zeros(2, 3, device=v.device), v))[1]),
         [rng.standard_normal((2, 5, 3)).astype(np.float32)]),
        ("TensorArrayScan", lambda nn, o: Apply(o.TensorArrayScan(
            Lam(lambda t: torch.sigmoid(t) * t), time_axis=2),
            lambda m, v: m(v)),
         [rng.standard_normal((2, 3, 4)).astype(np.float32)]),
    ]
    return cases


def _dedup_case(ids_shape, span, dim, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((span * 2, dim)).astype(np.float32)
    idx = rng.integers(0, span, size=ids_shape)
    cot = rng.standard_normal(ids_shape + (dim,)).astype(np.float32)
    return w, idx, cot


def dedup_held(device="cuda"):
    """dedup_gather's backward on the card against the CPU: bit for bit
    where no id repeats more than three times (the scan's order is the
    CPU's left-to-right sum there), within 1e-6 of the largest update
    beyond; the card's twice the same bits.  (readings, failed)."""
    from bigdl_tpu_torch.nn.sparse import dedup_gather
    failed, rows = [], {}
    for name, shape, span, dim in (("runs_le_3", (64,), 1000, 16),
                                   ("dup_heavy", (4096,), 64, 16),
                                   ("wide_dim1", (256, 4), 40, 1)):
        w, idx, cot = _dedup_case(shape, span, dim, len(name))
        if name == "runs_le_3":
            idx = np.repeat(np.arange(64), 3)[:64] * 7   # runs of 1-3
            np.random.default_rng(1).shuffle(idx)
        grads = []
        for dev in ("cpu", device, device):
            tw = torch.tensor(w, device=dev, requires_grad=True)
            dedup_gather(tw, torch.tensor(idx, device=dev)).backward(
                torch.tensor(cot, device=dev))
            grads.append(tw.grad.cpu())
        err = float((grads[1] - grads[0]).abs().max())
        scale = float(np.abs(cot).max())
        twice = torch.equal(grads[1], grads[2])
        rows[name] = dict(max_abs_err=err, same_bits_twice=twice,
                          max_run=int(np.bincount(idx.reshape(-1)).max()))
        if not twice:
            failed.append(f"dedup_gather {name}: two backwards on the card "
                          "differ")
        if (err != 0.0) if name == "runs_le_3" else (err > 1e-6 * scale *
                                                     rows[name]["max_run"]):
            failed.append(f"dedup_gather {name}: the card's gradient is "
                          f"{err:.3e} from the CPU's")
    return rows, failed


def random_ops_held(device="cuda"):
    """RandomUniform(-2, 3) and TruncatedNormal(1, 2) from a CUDA
    generator: in their bounds, their mean and variance within 5
    standard errors over 20000 draws, the same draws again from the same
    seed."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.core.module import forward_context
    n = 20000
    cases = (("RandomUniform", ops.RandomUniform(-2.0, 3.0), -2.0, 3.0, 0.5,
              25.0 / 12.0),
             ("TruncatedNormal", ops.TruncatedNormal(1.0, 2.0), -3.0, 5.0,
              1.0, 4.0 * (1.0 - 4.0 * 0.05399096651318806
                          / 0.9544997361036416)))
    failed, rows = [], {}
    for name, op, lo, hi, mean, var in cases:
        draws = []
        for _ in range(2):
            with forward_context(generator=torch.Generator(
                    device=device).manual_seed(3)):
                draws.append(op(np.asarray([n])))
        x = draws[0].double().cpu().numpy()
        rows[name] = dict(mean=float(x.mean()), var=float(x.var()),
                          lo=float(x.min()), hi=float(x.max()))
        if not (draws[0].device.type == torch.device(device).type
                and torch.equal(draws[0], draws[1])
                and x.min() >= lo and x.max() <= hi
                and abs(x.mean() - mean) < 5 * np.sqrt(var / n)
                and abs(x.var() - var) < 7.5 * var * np.sqrt(2.0 / n)):
            failed.append(f"{name}: draws {rows[name]} not U/N within "
                          f"[{lo}, {hi}], mean {mean}, var {var}")
    return rows, failed


def ops_9b_reading(device="cuda") -> dict:
    """The ops_9b phase's readings and failed checks: TF32 off; every op
    of ops/operations.py (ops_cases) on the card, its results left there
    (but HOST_OPS'), against the CPU and its definition, the random ops
    by bounds and moments, the sparse layers and the control-flow modules
    forward and backward against a CPU copy (LAYER_TOL), dedup_gather's
    backward (dedup_held); none launching #1-#11."""
    from bigdl_tpu_torch import nn, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _zero_counts()
    failed, held = [], 0
    for name, make, x, definition in ops_cases():
        y = make(ops, nn, device)(_on(x, device))
        ys = list(y) if isinstance(y, (tuple, list)) else [y]
        if name not in HOST_OPS and not all(
                torch.is_tensor(t) and t.device.type == "cuda" for t in ys):
            where = [getattr(t, "device", type(t)) for t in ys]
            failed.append(f"{name}: the card's run left results off the "
                          f"card: {where}")
        got = _host_list(y)
        want = _host_list(make(ops, nn, "cpu")(_on(x, "cpu")))
        failed += ops_held(name, got, want, definition)
        held += 1
    random_rows, bad = random_ops_held(device)
    failed += bad
    layers = {}
    for name, build, inputs in sparse_control_cases():
        cpu = build(nn, ops)
        card = _copy_to(cpu, device)
        runs = []
        for m, dev in ((cpu, "cpu"), (card, device)):
            xs = [torch.tensor(a, device=dev) for a in inputs]
            for t in xs:
                if t.is_floating_point():
                    t.requires_grad_(True)
            y = m(*xs)
            cot = torch.tensor(np.random.default_rng(50).standard_normal(
                tuple(y.shape)).astype(np.float32), device=dev)
            (y * cot).sum().backward()
            runs.append([y.detach().cpu()]
                        + [t.grad.cpu() for t in xs if t.grad is not None]
                        + [p.grad.cpu() for p in m.parameters()
                           if p.grad is not None])
        worst = 0.0
        for w, g in zip(*runs):
            err = (g - w).abs() - LAYER_TOL["rtol"] * w.abs()
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
        layers[name] = worst
        if len(runs[0]) != len(runs[1]) or not worst <= LAYER_TOL["atol"]:
            failed.append(f"{name}: the card's forward or backward is "
                          f"{worst:.3e} beyond rtol {LAYER_TOL['rtol']} of "
                          f"the CPU's (atol {LAYER_TOL['atol']})")
    dedup, bad = dedup_held(device)
    failed += bad
    launches = {"ops_9b": _read_counts()}
    if any(launches["ops_9b"].values()):
        failed.append(f"ops_9b launched a kernel of #1-#11: {launches}")
    return dict(ops=held, random=random_rows, layers=layers, dedup=dedup,
                launches=launches, seconds=time.perf_counter() - t0,
                failed=failed)


def phase_ops_9b(smi):
    """13l: see ops_9b_reading."""
    def report(r):
        worst = max(r["layers"].items(), key=lambda kv: kv[1])
        print(f"ops_9b: {r['ops']} ops of ops/operations.py on the card "
              f"against the CPU (floating results within rtol "
              f"{OPS_TOL['rtol']}, atol {OPS_TOL['atol']}; others and the "
              f"edge cases' definitions equal); random ops {r['random']}; "
              f"{len(r['layers'])} sparse and control-flow modules forward "
              f"and backward against a CPU copy, the largest excess over "
              f"rtol {worst[1]:.3e} ({worst[0]}); dedup_gather's backward "
              f"{r['dedup']}; launches of #1-#11 "
              f"{sum(r['launches']['ops_9b'].values())}; "
              f"{r['seconds']:.1f} s; on {smi}", flush=True)
    return _phase("ops_9b", ops_9b_reading, report)


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
    independent = row_independence(torch.Generator(device="cuda")
                                   .manual_seed(5))
    bwd = phase_bwd_kernel_checks(rates)
    ring = phase_partial_kernel_checks(rates)
    conv = phase_conv_kernel_checks(rates)
    serving, serving_routes, serving_kernels = phase_serving()
    prefix = phase_prefix(smi)
    oneshot = phase_oneshot(smi)
    beam = phase_beam(smi)
    train = phase_training()
    phase_train_parity()
    sp = phase_sp_training()
    phase_sp_parity()
    resnet = phase_resnet_training()
    phase_fused_vs_plain()
    phase_resnet_parity()
    phase_lenet()
    dispatch = phase_dispatch()
    resume = phase_resume(smi)
    remat = phase_remat(smi)
    prefetch = phase_prefetch(smi)
    phase_drain(smi)
    zoo = phase_zoo(smi)
    detection = phase_detection(smi)
    methods = phase_methods(smi, rates, dispatch["lm"])
    int8 = phase_int8(smi, rates)
    layers_9c = phase_layers_9c(smi)
    recommender = phase_recommender(smi)
    ops_9b = phase_ops_9b(smi)
    # the replays' launches, from the graph runs' device events
    replayed = {**{path: r["replayed"] for path, r in dispatch.items()},
                "resume": resume["replayed"],
                "lm_remat": remat["runs"]["remat_graph"]["replayed"]}
    by_path = {"serving": serving,
               "serving_prefix_cache": prefix["launches"],
               "serving_disaggregated": prefix["disagg_launches"],
               "oneshot_lm": oneshot["lm"]["launches"],
               "oneshot_resnet": oneshot["resnet"]["launches"],
               "beam_lm": beam["lm"]["launches"],
               "translation_beam": beam["translation"]["launches"],
               "serving_bf16_kv": beam["bf16_kv"]["launches"],
               "lm_training": train["launches"],
               "sp_training": sp["launches"],
               "resnet_training": resnet["launches"],
               "lm_remat_training": remat["runs"]["remat"]["launches"],
               "resnet_prefetch_training": prefetch["launches"],
               **{f"zoo_{model}_training": r["launches"]
                  for model, r in zoo["runs"].items()},
               **{f"zoo_ptb-lstm_{label}_training": r["launches"]
                  for label, r in zoo["ptb"].items()},
               "detection": detection["launches"],
               **methods["launches"],
               **int8["launches"],
               **layers_9c["launches"],
               **recommender["launches"],
               **ops_9b["launches"],
               **{f"{path}_graph_replays": r for path, r in replayed.items()}}

    def paths(name):
        return {path: counts[name] for path, counts in by_path.items()}

    def row(rows, kernel, shape):
        return next(r for r in rows
                    if r["kernel"] == kernel and r["shape"] == shape)

    csrc = "bigdl_tpu_torch/ops/csrc/"
    at_decode = next(s for s in shapes if s["shape"] == "b_decode")
    fwd = dict(_kernel_entry(
        "flash_attention_fwd", csrc + "flash_attention_fwd.cu",
        "bigdl_tpu/ops/attention_kernels.py:264",
        serving["flash_attention_fwd"], at_decode),
        kernel=at_decode["kernel"], scalar_ms=at_decode["scalar_ms"],
        share_of_bound=at_decode["share_of_bound"])
    # beside the serving path's decode row, the LM training path's row
    at_train = next(s for s in shapes if s["shape"] == "f_train")
    fwd["at_training_shape"] = dict(
        _kernel_entry("flash_attention_fwd", fwd["source"], fwd["replaces"],
                      train["launches"]["flash_attention_fwd"], at_train),
        kernel_route=at_train["route"], scalar_ms=at_train["scalar_ms"],
        ms_per_training_step=train["kernel_ms_per_step"][
            "flash_attention_fwd"])
    # and its mixed entry (a bf16 KV cache) at the decode and chunk shapes
    fwd["mixed_kv"] = [
        dict(_kernel_entry("flash_attention_fwd", fwd["source"],
                           fwd["replaces"],
                           beam["bf16_kv"]["routes"]["flash_attention_fwd"]
                           ["mixed_kv"], at),
             upcast_ms=at["upcast_ms"], f32_kv_ms=at["f32_kv_ms"],
             kernel=at["kernel"], scalar_ms=at["scalar_ms"],
             share_of_bound=at["share_of_bound"])
        for at in shapes if at["shape"] in MIXED_SHAPES]
    fwd["shapes"] = shapes
    # the serving paths' launches by the kernel each ran, and the rows
    # held bit for bit among others, alone and over masked keys
    fwd["launches_by_kernel"] = {
        "serving": serving_kernels,
        "serving_prefix_cache": prefix["kernels"],
        "serving_disaggregated": prefix["disagg_kernels"],
        "oneshot_lm": oneshot["lm"]["kernels"],
        "beam_lm": beam["lm"]["kernels"],
        "translation_beam": beam["translation"]["kernels"],
        "serving_bf16_kv": beam["bf16_kv"]["kernels"]}
    fwd["row_independence"] = independent
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
                      "serving_prefix_cache": prefix["routes"],
                      "serving_disaggregated": prefix["disagg_routes"],
                      "oneshot_lm": oneshot["lm"]["routes"],
                      "beam_lm": beam["lm"]["routes"],
                      "translation_beam": beam["translation"]["routes"],
                      "serving_bf16_kv": beam["bf16_kv"]["routes"],
                      "lm_training": train["routes"],
                      "sp_training": sp["routes"],
                      "resnet_training": resnet["routes"],
                      # by the tensor-core kernel each replay ran
                      **{f"{path}_graph_replays": {
                          n: {"tensor_core": c} for n, c in r.items()}
                         for path, r in replayed.items()}}
    for name, design in (
            ("flash_attention_fwd",
             "tensor cores for bf16 with 16-byte rows (mma.sync.m16n8k16 "
             "bf16->f32, #5's FlashAttention-2 forward loop from a fresh "
             "state: 64 query rows per block, heaviest blocks first, Q "
             "fragments in registers, 64-key K/V tiles through two "
             "cp.async stages, the f32 bias through its strides, P "
             "rounded to bf16 from the S fragments, out = acc / l and lse "
             "in the epilogue); for f32 q (serving, f32 training) with "
             "16-byte rows, f32 FMAs on the CUDA cores: at Tq 1 "
             "flash_decode_kernel (the keys split at fixed 128-key "
             "positions over blocks, K and V in two cp.async groups of "
             "16-byte copies, a key a thread, the splits' (acc, m, l) "
             "folded in key order by flash_merge_kernel), at Tq > 1 "
             "flash_tile_kernel (32 query rows a block, 64-key K/V tiles "
             "through two cp.async stages, 8 rows x 2 keys of S and 8 rows "
             "x D/32 columns of acc a lane, each tile's softmax folded in "
             "key order, the tiles spread over blocks and merged where "
             "B*H*(row blocks) is below the SM count); f32 q with bf16 K/V "
             "(a bf16 KV cache) on the same kernels, K read once: the "
             "scores kept, the row's (m, l) folded, then P normalised, "
             "rounded to bf16, and P.V; other rows on the scalar "
             "template"),
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
