#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the port (``src/repro_torch``) only, never the JAX package:

  1. build   compile the qmatmul, kvattn and fakequant CUDA libraries from
             the checkout's sources, one nvcc each, all at once; print each
             one's ptxas registers and spills
  2. parity  hold the ``qgemv`` and ``qmatmul`` kernels against their plain
             PyTorch versions on the card over the serving shapes of
             brecq-lm-100m (decode M 1 and 8; qmatmul at M 8, the decode
             tier off, and 16, the 16-slot engine's decode, M 32, the
             engine's chunk, 64 and 512; ragged M and N), for 2/4/8-bit codes,
             per-channel and group-128 scales; time kernel, plain version,
             library yardstick (torch.matmul on the pre-dequantized
             weight) and the bound at the slice shapes (for the
             tensor-core bodies: bytes, or two TF32 / three bf16 passes;
             the f32 CUDA-core bound beside it)
  3. kv      hold ``kv_decode`` against its plain version (the engine's
             shape, GQA, MQA, ragged S, a window, kpos holes, a row with no
             valid slot, head dim 120 with G 4 on the 8-byte body), and its
             paged entry against the dense kernel on the gathered view, bit
             for bit (idle rows, holes, hd 120, S_cap 2048, a forced split);
             time kernel, plain version, library yardstick
             (scaled_dot_product_attention on pre-dequantized,
             head-expanded K/V) and the bound at the engine's shape, at S
             1024, 2048 and 4096 and at head dim 120, and the paged entry
             beside the gather + casts + dense kernel it replaces
  4. serve   run ``repro_torch.launch.serve.main`` at full width (batch 8,
             prompt 64, gen 32) for --quant 4 and --quant 2, save the
             artifact, serve it again through --artifact; check that both
             kernels were launched, every decode launch on the tensor-core
             decode body and every prefill launch on the tensor-core tile,
             then replay the generated tokens through the plain PyTorch
             path and compare the logits
  5. engine  run ``serve.main --quant 4 --engine`` at full width (8 slots,
             16 staggered streams, int8 paged KV) on random weights scaled
             so that the greedy tokens vary; check that all three kernels
             were launched and no page leaked; serve the same schedule
             through the kernels and through the plain versions (int8 and
             float32 pools; kv_decode also held against its plain version
             on every call's inputs; the pools' codes compared), through a
             deliberately wrong kv_decode (the logits limit must catch it),
             staggered vs sequential (4 streams), and under page pressure
             (tokens and logits against the unpressured run); every
             kv_decode launch on the paged entry. Then the long-context
             engine (in a process of its own, see 17): 8 streams of
             prompts up to 2016 tokens (S_cap 2048), every kv_decode launch
             paged and split over a cluster, every kv read shadowed by its
             plain version, kernel vs plain logits
  6. moe     hold ``qmatmul_grouped`` against its plain versions at
             deepseek-moe-16b's expert shapes (E 64; M 4, 8, 9, 64; W4, W2,
             group-128 scales, W3 codes in an int8 container, ragged N) and
             catch a deliberately wrong one; time kernel, plain version,
             library yardstick (torch.bmm on the pre-dequantized weight)
             and bound per MoE layer at M 8 and 64; serve deepseek-moe-16b
             at full width, depth cut to 4 layers (1 dense + 3 MoE), W4,
             capacity routing: fixed batch (8 x 64 prompt, 32 generated;
             expected grouped launches counted, the plain path replays the
             tokens) and the engine (8 slots, int8 pool; staggered ==
             sequential bit for bit on 4 streams)
  6b. audit  the program audit on the card (``analysis/audit``,
             ``build_programs("quick", with_calib=True, device="cuda")``):
             the qmm tiers, serve decode and prefill of brecq-lm-100m and
             deepseek-moe-16b, the engine's two programs, budget decode and
             the captured calibration scan under the four program rules,
             ``no_host_transfer`` under ``set_sync_debug_mode("error")``;
             no violation that is not suppressed, each suppression printed
             with its reason; ``no_host_transfer`` fires on a seeded
             ``.cpu()`` of a CUDA tensor. Then ``optrace.analyze_step`` and
             ``roofline.from_step`` on brecq-lm-100m at full width and depth,
             RTN W4: the fixed batch's decode step (batch 8) and its 8 x 64
             prefill, one ``[audit]`` line each (FLOPs, bytes, bottleneck,
             bound, mem_frac against ``ideal_serve_bytes``, the step's wall
             between CUDA events); the decode step's recorded weight bytes
             within AUDIT_BYTES_TOL of the packed leaves' ``nbytes``. Alone
             on the card, within AUDIT_LIMIT_S; its launches are taken back
             out of the kernels' counts
  7. train   train brecq-lm-100m at full width and depth through
             ``repro_torch.launch.train.main`` with deterministic CUDA
             algorithms: 20 steps under the CLI's defaults (batch 16 x 128
             tokens, Adam under a cosine schedule, --remat dots) unbroken,
             stopped by SIGTERM at step 10 and resumed, and under --remat
             none, all equal bit for bit (every param and Adam moment);
             then TRAIN_ARGS (1000 steps, async checkpoints every 100);
             per-step ms, first and final loss, device peak; the FP loss
             on QUALITY_BATCHES held-out batches below HELDOUT_FP_MAX
  8. calib   hold ``fakequant`` (K5) against its plain version at
             brecq-lm-100m's linear shapes and a ragged one (W2/W4, (1, N)
             and (K, N) scales; hard bit for bit, soft within
             1e-6*max|ref|) and catch a deliberately wrong one; time it;
             calibrate the trained brecq-lm-100m at full width and depth
             (W2 and W4, block reconstruction with the streamed Fisher)
             through ``repro_torch.core.quantize`` with every K5 call
             shadowed by its plain version and its launches counted;
             eval loss and logits MSE against FP of BRECQ and RTN at W2 and
             W4 on QUALITY_BATCHES held-out batches, BRECQ-W2 closer to FP
             than RTN-W2 in both;
             export, save, load (weights equal to params_q bit for bit)
             and serve the W2 artifact through the fixed batch (plain path
             replays the tokens); the W4 artifact served through
             ``serve.main --artifact`` (K1 and K2 launched), replayed
  9. baselines  the paper's PTQ baselines on the same trained
             brecq-lm-100m at full width and depth, on the calib phase's 32
             x 128 tokens, at W2 and W4: min-max RTN, OMSE, bias correction,
             AdaQuant (40 iterations a layer) and LAPQ (84 layers x 6 clip
             ratios), and RTN W2A4; eval loss, top-1, logits MSE against FP
             and wall of each on QUALITY_BATCHES held-out batches beside the
             calib phase's BRECQ and RTN-on-BRECQ's-scales rows; BRECQ W2
             below min-max RTN W2 and bias correction W2 in eval loss
 10. mixed   BRECQ mixed precision on the trained brecq-lm-100m: a W8
             calibration beside the W2 and W4 ones; the sensitivity
             table on 32 sequences (12 blocks x (21 diagonal + 21 pair
             probes), every hardened forward through K5, shadowed); the exact
             solver with storage groups under a bytes budget halfway between
             all-W2 and all-W4, and without groups against the genetic search
             (never worse); the calibrated mixed artifact (per-layer bits,
             export) within its budget, with the containers of
             ``rtn_mixed_artifact``, served through K1/K2 and replayed; then
             ``serve.main --budget-decode-ms X --dispatch measured``, X midway
             between the all-fastest and all-slowest assignment of a cost
             table timed on K1/K2 (CUDA graph replays between CUDA events):
             the solve within X, the measured dispatch installed and routing
             the served matmuls, the logits replayed by the plain path
 11. deploy  the repo's deployment tables on brecq-lm-100m at full width and
             depth through ``benchmarks_torch``: table 6 (fixed batch 8 x 64
             + 32, FP against packed W4 with the decode tier on and off),
             table 7 (64 staggered streams through the engine, 16 slots,
             int8 and fp16 pools, and a pool cut to 35% under worst-case and
             optimistic admission) and table 8 (the budget frontier: the
             exact solver against unified W2/W4/W8 and the GA at 5 byte and 3
             latency budgets, the latter on K1/K2 timed from CUDA graphs);
             the reference's ``check_serve_bench.py`` and
             ``check_budget_bench.py`` on the three files; table 7's
             scheduler counters equal to the reference's and its fp16/int8
             KV bytes 1.939; K1, K2 (M 16 on the engine's decode) and K4
             counted; table 7's first 16 streams replayed with logits, int8
             pool through the kernels against the plain path and fp16 pool
             through the kernels against a float32 pool on the plain path;
             the packed decode step beside its roofline bound
 12. calib_moe  BRECQ W2 calibration of deepseek-moe-16b at full width, cut
             to 4 layers (the dense layer + 3 MoE layers), 16 x 128 tokens, 50
             iterations a block: every K5 call shadowed (bit for bit), its
             launches on stacks of experts ((64*2048, 1408) views) counted
             apart; BRECQ-W2 closer to FP than RTN-W2 on held-out logits;
             export, verified load, fixed batch served through
             qmatmul_grouped (M 64 prefill, M 8 decode) and replayed; K5 timed
             at one expert leaf
 13. family  hold qgemv, qmatmul and kv_decode against their plain
             versions at the attention families' new shapes and time them
             there: qgemv on llama-3.2-vision-90b's MLP (8192 x 28672 and
             back, W4 and W2: off L2), qmatmul over whisper-small's encoder
             (M 12000) and the VLM's cross-attention K/V (M 8192, K 8192),
             kv_decode's paged entry at h2o-danube3-4b's (hd 120, G 4) and
             gemma3-12b's (hd 256, G 2) decode reads, with a window that masks
 14. whisper whisper-small at full width, 6 encoder + 6 decoder of its
             12 + 12 layers (cut for the run's wall), every
             cross-attention gate at 1.0, 32 x 128 tokens
             over 1500 frames each: BRECQ W4 calibration (encoder units, the
             boundary, decoder units; every K5 call shadowed), BRECQ closer
             to FP than RTN on held-out logits and on the last encoder
             block's output, export and verified load, a fixed batch (8 x 64
             + 32 over 1500 frames) served through K2 (the encoder, M 12000)
             and K1 (decode, counted per step), replayed by the plain path;
             redrawn frames move the logits
 15. vlm     llama-3.2-vision-90b at full width, cut to one group of 5
             layers (4 self-attention + 1 gated cross-attention): RTN W4 on
             the card, a fixed batch of 8 x 64 + 32 with 1024 patches an
             image, K1 on 8192 x 28672 counted, replayed by the plain path;
             redrawn patches move the logits
 16. dense   h2o-danube3-4b at full width (6 of 24 layers: cut
             for the run's wall), gemma3-12b at full
             width (one 5 local + 1 global group) and internlm2-20b at full
             width (4 of 48 layers) through the engine: RTN W4, int8 pool, 8
             slots, 16 streams of 64-256 prompt tokens; every kv_decode
             launch on the paged entry (8-byte body at hd 120, 16-byte body
             at hd 256 and at hd 128 with G 6) and shadowed, kernel vs plain
             logits, staggered == sequential
 17. recurrent  hold qgemv (M 8), qmatmul (M 512) and fakequant against
             their plain versions at the recurrent families' new shapes (N 8
             and 16 gate projections, hymba's head of N 32001, K 1600 and
             3200; W4 and W2) and at whisper-small's head (768 x 51865), and
             time them there. Order from 12 on: 12 (with 20's probe
             beside it), 13, 17, 15, then 14 and 16 in this process while
             20's ranks and dry runs, 5's long-context engine and 18-19
             (``--phase engine_long``, ``--phase recurrent``: a process
             each, results pickled) and ``examples/torch_quickstart.py``
             (QUICKSTART_SMOKE=1: its exit code and its BRECQ-W2 perplexity
             below its RTN-W2 gated) run beside them; none of those times a
             kernel, so only their own throughputs share the card
 18. xlstm   xlstm-350m at full width and depth (4 blocks of 5 mLSTM + 1
             sLSTM): BRECQ W4 calibration (32 x 128 tokens, 100 iterations a
             block; every K5 call shadowed), BRECQ closer to FP than RTN on
             held-out logits, export and verified load, a fixed batch (8 x 64
             + 32) served through K2 and K1 (launches counted), replayed by
             the plain path; prefill + 8 decode steps against the forward at
             the same positions, through the kernels and on qmm's plain
             backend; the associative scans' and mLSTM chunks'
             share of a prefill (CUDA events)
 19. hymba   hymba-1.5b at full width: at full depth, RTN W4 served as
             xlstm's fixed batch (same checks); cut to 4 layers, BRECQ W4
             calibration, export, verified load and the calibrated artifact
             served the same way
 20. dist    two ranks on the one H100 (gloo: NCCL refuses two ranks on
             one device), spawned apart from this process beside 14 and 16
             (see 17; this phase then waits for them, holds their results
             and times K1/K2 alone on the card): the gloo probe
             (``scripts/dist_probe.py``: which collectives gloo takes on
             CUDA tensors); brecq-lm-100m at full width and depth: the int8
             error-feedback all-reduce on each rank's real gradients against
             its arithmetic on both ranks' gradients (exact), then 20 steps
             of ``make_dp_train_step`` on a global batch of 16 x 128 beside
             the uncompressed f32 data-parallel run (loss falls, error
             buffer non-zero, int8 - f32 at every step within
             -DIST_LOSS_BELOW .. DIST_LOSS_ABOVE);
             ``make_train_step`` under dp, tp, fsdp and zero3 on the (data 1,
             model 2) mesh against the same step on whole tensors (loss,
             gradient norm, params, each leaf's gradient), bytes of
             params and Adam state per rank (tp/fsdp/zero3 about half of
             dp's); RTN W4 served (8 x 64 prompt + 32 greedy) by
             ``make_prefill_step`` and ``make_decode_step`` under
             ``Plan("tp")``: every packed matmul on each rank's N/2 columns
             of the codes (K2 at prefill, K1 at decode, counted per rank
             against the expected), codes bytes per rank half the whole,
             logits against the one-rank serve within the kernels' limit, a
             decode step timed beside the one-rank step; K1 and K2 timed at
             the half-N shapes; the dry run (``launch/dryrun.py``, fake
             process group of 256 ranks on the (32, 8) mesh) of
             tinyllama-1.1b train_4k and W4 decode_32k
 21. report  one JSON line of kernels (qmatmul at M 32 and, as added
             fields, M 512; qmatmul_grouped at M 8 and, as added fields, M
             64; the launches of each body on the main paths, for qgemv,
             qmatmul, qmatmul_grouped and kv_decode, whose launches are also
             counted by entry and by split; the launches of the mixed,
             deploy (per table), calib_moe, the attention families', the
             recurrent families'
             and the trained model's paths, and the times at the families'
             shapes), the run's wall,
             the card's name and power limit, and the final
             ``{"ok": true, "device": ...}`` line

Exits non-zero on any failure, and when no CUDA device is available.

    python3 chip_smoke.py [--json PATH]
    python3 chip_smoke.py --phase engine_long|recurrent --phase-out FILE
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), from the port's roofline
# (repro_torch.analysis.roofline): HBM3 bandwidth, f32 outside the tensor
# cores (kv_decode, fakequant and the CUDA-core bodies kept for short scale
# groups), and dense TF32 and bf16 on the tensor cores (the short tile in
# two TF32 passes; the wide tile and the decode body of qgemv and
# qmatmul_grouped at M <= 8 in three bf16 passes). The roofline module
# imports without torch; with no port beside this script, the import fails.
# A call's bytes are those the kernel wrappers report (kernels/record.py).
sys.path.insert(0, str(SRC))
from repro_torch.analysis.roofline import HBM_BW, PEAK_F32, PEAK_FLOPS, PEAK_TF32  # noqa: E402
from repro_torch.kernels.record import fq_work, qmm_work  # noqa: E402

# operations per multiply-add and peak rate of each body's arithmetic
ARITH = {"f32": (2, PEAK_F32), "tf32x2": (4, PEAK_TF32), "bf16x3": (6, PEAK_FLOPS)}

# (K, N) of one brecq-lm-100m layer's packed matmuls, with how many of the
# layer's 7 matmuls have that shape: wq/wk/wv/wo, w_gate/w_up, w_down.
SLICE_SHAPES = {(768, 768): 4, (768, 2048): 2, (2048, 768): 1}
RAGGED_N = 200
L2_FLUSH_BYTES = 100e6  # weight copies per timing: twice the 50 MB L2
DECODE_M = (1, 8)
# the decode tier switched off (M 8), the 16-slot engine's decode (M 16,
# a half-filled short tile), the engine's prefill chunk, the wide tile's
# first M, fixed batch, ragged M
PREFILL_M = (8, 16, 32, 64, 512, 520)
TIMED_M = (8, 32, 512)  # decode, the engine's prefill chunk, fixed-batch prefill

# kv_decode parity cases (B, H, K, hd, S, window, kpos holes, empty row):
# the engine's decode shape (8 slots, 12 heads, 6 pages of 16), GQA at
# TinyLlama's width, MQA at hd 128, ragged S, a window, holes, a row with
# no valid slot
KV_CASES = [(8, 12, 12, 64, 96, None, False, False),
            (8, 32, 4, 64, 2048, None, False, False),
            (4, 16, 1, 128, 1024, None, False, False),
            (8, 12, 12, 64, 100, None, False, False),
            (8, 12, 12, 64, 256, 64, False, False),
            (8, 12, 12, 64, 96, None, True, False),
            (8, 12, 12, 64, 96, None, False, True),
            # h2o-danube3-4b's heads: 32 over 8 kv heads of 120 (the 8-byte body)
            (8, 32, 8, 120, 96, None, False, False),
            (4, 32, 8, 120, 1000, 64, True, False)]
# paged-entry parity cases (B, H, K, hd, page size, max pages, holes, idle
# rows): the engine's decode shape with two idle slots, GQA with holes over
# pages of 4, hd 120 (G 4), the long-context engine's S_cap 2048 (split), and
# a page size that does not divide the kernel's tile
KV_PAGED_CASES = [(8, 12, 12, 64, 16, 6, False, 2), (3, 8, 2, 64, 4, 9, True, 1),
                  (8, 32, 8, 120, 16, 6, True, 0), (8, 12, 12, 64, 16, 128, False, 2),
                  (3, 4, 1, 120, 5, 40, True, 1)]
KV_TIMED = {"engine": (8, 12, 12, 64, 96), "s1024": (8, 12, 12, 64, 1024),
            "s2048": (8, 12, 12, 64, 2048), "long": (8, 12, 12, 64, 4096),
            "hd120": (8, 32, 8, 120, 96)}
ENGINE_ARGS = ["--arch", "brecq_lm_100m", "--quant", "4", "--engine",
               "--batch", "8", "--prompt-len", "64", "--gen-len", "32",
               "--seed", "0", "--kv-dtype", "int8"]
# the long-context engine phase: 8 slots and 8 streams of prompts up to 2016
# tokens, S_cap 2048 (a worst-case pool of 1 + 8 x 128 pages), so that every
# kv_decode launch splits S over a cluster
LONG_ENGINE_ARGS = ["--arch", "brecq_lm_100m", "--quant", "4", "--engine",
                    "--batch", "8", "--prompt-len", "2016", "--gen-len", "32",
                    "--streams", "8", "--seed", "0", "--kv-dtype", "int8"]
PRESSURE_PAGES = 19  # below the worst case of 1 + 8 x 6; forces preemptions
MIN_DISTINCT_TOKENS = 4  # median distinct greedy tokens per engine stream
MIN_STEPS_SHARED = 0.5  # of an engine comparison's steps on a shared history
# Engine logits over a shared token history, kernel path vs plain path (and
# a preempted stream vs its unpressured run). The paths compute K/V through
# other f32 sums, so a value near an int8 rounding boundary takes the
# neighbouring code in one of them, and such one-step flips, through 12
# layers of weights at 3x their init range, move the logits. On an H100 the
# int8-pool paths differ by 1.8e-2 of max |logit|; with float32 pools, which
# hold no codes to flip, by 1.2e-5; a kv_decode that drops the newest key
# gives 0.91 (PERF.md). The limit sits between: ~3x the int8 reading.
ENGINE_LOGIT_TOL = 5e-2  # of max |logit|

# (K, N) of one deepseek-moe-16b MoE layer's routed-expert matmuls, with how
# many of the layer's 3 calls have that shape: w_gate/w_up, w_down; 64 experts
MOE_SHAPES = {(2048, 1408): 2, (1408, 2048): 1}
MOE_E = 64
# rows per expert: the engine's prefill chunk (32 tokens), decode (8
# sequences), a ragged tile, the fixed-batch prefill (64 tokens x 8)
MOE_PARITY_M = (4, 8, 9, 64)
MOE_TIMED_M = (8, 64)  # decode, fixed-batch prefill
# (bits, group, K, N) parity cases: the served W4 shapes, W2, group-128
# scales, W3 codes in an int8 container, a ragged N
MOE_CASES = [(4, None, 2048, 1408), (4, None, 1408, 2048), (2, None, 2048, 1408),
             (4, 128, 2048, 1408), (3, None, 1408, 2048), (4, None, 2048, 200)]
MOE_LAYERS = 4  # depth cut of deepseek-moe-16b: its dense layer + 3 MoE layers

# fakequant (K5) parity shapes: brecq-lm-100m's three linear shapes and a
# ragged one (N % 4 != 0: the scalar path)
FQ_SHAPES = list(SLICE_SHAPES) + [(100, 300), (100, 301)]
# calibration of brecq-lm-100m at full width and depth: 32 sequences x 128
# tokens, W2, 200 iterations per block, minibatch 8 (the other fields are
# ReconConfig's defaults: block units, streamed Fisher, bf16 streams, guard)
CALIB_SEQS, CALIB_LEN, CALIB_ITERS = 32, 128, 200
# the W4 calibration beside it: 100 iterations a block (W4's rounding moves
# little from RTN's; cut from 200 to keep the run's wall near 600 s)
CALIB_W4_ITERS = 100
HELDOUT_SEQS = 8
# the trained brecq-lm-100m's quality (train and calib phases) is read on
# QUALITY_BATCHES held-out batches of HELDOUT_SEQS x CALIB_LEN: 8,192 tokens
QUALITY_BATCHES = 8
MOE_ENGINE_STREAMS = 8
# MoE calibration of deepseek-moe-16b at full width, cut to MOE_LAYERS: 16
# sequences x 128 tokens, W2, 50 iterations per block, minibatch 8
MOE_CALIB_SEQS, MOE_CALIB_ITERS = 16, 50
# training of brecq-lm-100m at full width and depth through the port's
# trainer, on the CLI's defaults (batch 16 x 128 tokens, lr 3e-3, warmup
# 20) but for TRAIN_ARGS. The defaults' 300 steps leave the held-out loss at
# 8.35 nats, 0.66 below ln(8192) (PERF.md); 1000 steps reach 5.50.
# --remat none: the same bits as the default dots (each run checks it over
# RESUME_STEPS), whose selective checkpointing costs ~0.2 s a step in
# Python dispatch. RESUME_STEPS: SIGTERM during the first, resumed to the
# second. The trained model must reach a held-out FP loss below
# HELDOUT_FP_MAX: 1.51 nats below ln(8192) = 9.01, the loss of uniform
# guessing (the criterion asks for 7.5, and for 1.5 nats below ln(vocab))
TRAIN_STEPS = 1000
TRAIN_ARGS = ["--steps", str(TRAIN_STEPS), "--remat", "none", "--ckpt-every", "100"]
RESUME_STEPS = (10, 20)
HELDOUT_FP_MAX = 7.5
# the PTQ baselines on the trained brecq-lm-100m: AdaQuant's iterations a
# layer are the paper tables' (benchmarks_torch: RECON_ITERS // 2)
BASELINE_ADAQUANT_ITERS = 40
# mixed precision on brecq-lm-100m: W4/W8 calibrations for the sensitivity
# table, the table on 32 sequences, the per-layer-bits calibration (50
# iterations a block since the train phase came: 100 before)
SENS_ITERS, SENS_SEQS, MIXED_ITERS = 50, 32, 50


# the attention families (every cross-attention gate at XGATE: JAX's init
# of 0 would make the logits blind to the frames and the patches).
# whisper-small at full width, WHISPER_LAYERS encoder + decoder layers,
# 32 sequences of 128 decoder tokens over WHISPER_FRAMES frames each
# (Whisper's 30 s window), W4, 50 iterations a block (100 before the train
# phase came), minibatch 8
XGATE = 1.0
WHISPER_FRAMES, WHISPER_SEQS, WHISPER_ITERS = 1500, 32, 50
# depth cuts for the run's wall, which must stay well inside the 1,200 s
# limit on the slowest host the run meets: whisper-small's 12 + 12 layers
# to 6 + 6, h2o-danube3-4b's 24 to 6. On an H100 80GB HBM3 at 700 W,
# uncut, the phases before dist took 909.1 s (whisper 66.0 s, danube
# 48.0 s); danube at 12 layers took 21.6 s on a host where the whole run
# took 779.5 s, and a run past 1,200 s was refused
WHISPER_LAYERS = 6
DANUBE_LAYERS = 6
# llama-3.2-vision-90b at full width, cut from 100 layers to one group of
# 5 (4 self-attention + 1 gated cross-attention): 25.5 GB as f32
VLM_LAYERS = 5
# gemma3-12b at full width, cut from 48 layers to one 5 local + 1 global
# group (12 GB as f32, 8 of it the untied 262,144-word table and head);
# h2o-danube3-4b at full width (24 layers are 15.9 GB)
GEMMA_LAYERS = 6
DENSE_ENGINE_STREAMS, DENSE_PROMPTS = 16, (64, 256)
# (kernel, M, K, N, bits, timing label): K1 on the VLM's MLP, W4 and W2,
# both ways (117 MB of W4 codes: off L2); K2 over whisper's encoder (8 x
# 1,500 frames into its MLP) and the VLM's cross-attention K/V (8 x 1,024
# patches)
FAMILY_QMM = [("qgemv", 8, 8192, 28672, 4, "vlm_mlp"), ("qgemv", 8, 28672, 8192, 4, None),
              ("qgemv", 8, 8192, 28672, 2, None), ("qgemv", 8, 28672, 8192, 2, None),
              ("qmatmul", 12000, 768, 3072, 4, "whisper_enc"),
              ("qmatmul", 8192, 8192, 1024, 4, "vlm_xkv")]
# K4's paged entry at the dense engines' decode reads (B, H, K, hd, page
# size, pages a stream, window): 8 slots over S_cap 288, one idle; also
# held against the plain version under a window that masks. internlm2-20b's
# 48 heads over 8 of 128 put G 6 on the 16-byte body
FAMILY_KV = {"danube": (8, 32, 8, 120, 16, 18, 4096),
             "gemma3": (8, 16, 8, 256, 16, 18, 1024),
             "internlm2": (8, 48, 8, 128, 16, 18, None)}
FAMILY_KV_MASKING_WINDOW = 100
# Redrawing the memory must move the served prefill logits by more than
# this many times the kernel-vs-plain replay limit (1e-3 * max|logit|).
# Whisper's decoder cross-attends in all 12 layers; the VLM's one gated
# cross-attention layer averages 1,024 random patches, which moves its
# logits ~20x the limit on random weights (PERF.md).
MEMORY_MOVES = {"whisper": 100, "vlm": 10}


# the recurrent families. xlstm-350m at full width and depth (24 layers = 4
# blocks of 5 mLSTM + 1 sLSTM), BRECQ W4 as whisper's phase: 32 x 128
# tokens, minibatch 8, 100 iterations a block. hymba-1.5b at full width: at
# full depth (32 layers) RTN W4 served; its depth cut to HYMBA_CALIB_LAYERS
# for BRECQ W4 (chip time)
RECURRENT_SEQS, RECURRENT_ITERS = 32, 100
HYMBA_CALIB_LAYERS = 4
# decode steps held against the forward at the same positions: each step's
# recurrent state is written into the cache's views in place. Through the
# kernels the forward and the cached path run other kernels (K2 over all
# 8 x 72 rows; K2 over the prompt, then K1 at 8 rows), and xlstm-350m at
# random init amplifies their rounding. Measured on an H100 (PERF.md), in
# units of max |logit|, on the calibrated xlstm artifact this phase serves:
# through the kernels 6.5e-4 (2.445e-3), with qmm's plain backend on the
# card 2.2e-4 (8.20e-4); on an RTN W4 one 7.0e-3 and 5.0e-4; the FP weights
# on the card 3.1e-4, the plain path on the CPU 2.6e-4. The cached path is
# sound: the plain backend is held at DECODE_VS_FORWARD_PLAIN_TOL, the
# kernels at DECODE_VS_FORWARD_TOL; a step from a lost state is off by
# about max |logit|, which each run checks.
DECODE_VS_FORWARD_STEPS = 8
DECODE_VS_FORWARD_TOL = 1e-2  # of max |logit|, through the kernels
DECODE_VS_FORWARD_PLAIN_TOL = 1e-3  # of max |logit|, qmm's plain backend
# (label, K, N) the recurrent families give K1 (M 8), K2 (M 512) and K5: the
# gate projections of N 8 (xlstm's w_if) and 16 (hymba's wB/wC), hymba's head
# of N 32,001 (not a multiple of 16), and the rest of both families' linears
RECURRENT_SHAPES = [("xlstm_w_if", 2048, 8), ("xlstm_in_proj", 1024, 4096),
                    ("xlstm_wqkv", 2048, 2048), ("xlstm_w_in", 1024, 8192),
                    ("xlstm_out_proj", 2048, 1024), ("xlstm_head", 1024, 50304),
                    ("hymba_wBC", 3200, 16), ("hymba_w_dt", 3200, 3200),
                    ("hymba_in_proj", 1600, 6400), ("hymba_wqo", 1600, 1600),
                    ("hymba_wkv", 1600, 320), ("hymba_mlp", 1600, 5504),
                    ("hymba_head", 1600, 32001)]
# whisper-small's untied head (N 51,865, odd): on K1 in every whisper decode
# step; held and timed beside the recurrent families' shapes
HEAD_SHAPES = [("whisper_head", 768, 51865)]
# internlm2-20b at full width, its depth cut from 48 layers (≈ 80 GB as f32)
# to INTERNLM_LAYERS (10.8 GB, 4.5 of it the untied 92,544-word table and head)
INTERNLM_LAYERS = 4

# The deploy phase: the repo's deployment tables 6-8 (benchmarks_torch) on
# brecq-lm-100m at full width and depth. Table 7's scheduler counters at
# the reference's defaults (64 streams, 16 slots, prompt 48, gen 48, chunk
# 32, page 16, seed 0, pool fraction 0.35) as the JAX package's tracked
# BENCH_serve_mt.json holds them (its reduced config: they depend on
# lengths, pages and slots only, not on widths): decode ticks, tokens,
# peak pages, preemptions, replayed prefill chunks, mean slot occupancy.
T7_KEYS = ("decode_ticks", "tokens_generated", "peak_pages_in_use", "preemptions",
           "replay_prefill_chunks", "mean_slot_occupancy")
T7_COUNTERS = {"int8": (197, 2418, 70, 0, 0, 0.747),
               "fp16": (197, 2418, 70, 0, 0, 0.747),
               "pressure.none": (432, 2418, 28, 0, 0, 0.341),
               "pressure.prompt": (366, 2418, 33, 18, 32, 0.402)}
# fp16 over int8 KV bytes a page at full width: 12 layers x 16 slots x 12
# heads x 64 x 2 (K, V) x 2 bytes against 12 x 16 x 12 x (64 x 2 codes + 2
# x 2 f16 scale bytes)
T7_KV_RATIO = round(589_824 / 304_128, 3)
# table 7's run replayed for its values: its first T7_REPLAY_STREAMS streams
# (as many as its slots, so every decode tick is a 16-row K2 call) on its
# own artifact, int8 pool through the kernels against the plain path, and
# fp16 pool through the kernels against a float32 pool on the plain path
T7_REPLAY_STREAMS = 16
# the reference checkers' measured floors, pinned for a CPU runner; printed
# beside the card's ratios and passed to the checkers as 0 (on the card the
# decode step follows the host, and both passes run the same host code)
T6_MIN_TIER_RATIO, T8_MIN_TOK_RATIO = 0.85, 0.5


def tolerance(ref) -> float:
    """Kernel vs plain version: f32 sums in another order."""
    return 1e-4 * float(ref.abs().max()) + 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(m: int, k: int, n: int, bits: int, g: int,
          arith: str = "f32") -> tuple[float, str, float]:
    """Least time (ms) for x (m,k) f32 @ packed (k*bits/8, n) + scales (g,n)
    -> (m,n) f32: each input read once, the output written once, against
    the operations of the arithmetic the body uses (``ARITH``: two TF32
    passes, 4mkn, or three bf16 passes, 6mkn, on the tensor cores; 2mkn f32
    on CUDA cores). Returns (ms, "bytes" or "operations", the f32 CUDA-core
    bound in ms, which earlier rows used)."""
    t_bytes = qmm_work("qmm", 1, m, k, n, bits, g).bytes / HBM_BW * 1e3
    t_f32 = max(t_bytes, 2 * m * k * n / PEAK_F32 * 1e3)
    per, peak = ARITH[arith]
    t_ops = per * m * k * n / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_f32,)


def graph_time_ms(torch, fn, arg_sets, replays: int = 3) -> float:
    """Device time per call: one call per entry of ``arg_sets`` (whose
    weights together exceed the 50 MB L2, so every call reads its weight
    from device memory, as the serving path does with 84 distinct
    weights per step) captured in one CUDA graph and replayed ``replays``
    times between CUDA events. The graph takes the host's launch overhead
    out of the measurement."""
    reps = max(len(arg_sets), 32)
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del g
    return ms


def phase_build(kernels) -> dict:
    """Build every library at once (one nvcc each, in threads)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(lambda k: k.load_library(), kernels.values()))
    infos = {}
    for name, kernel in kernels.items():
        info = infos[name] = dict(kernel.BUILD_INFO)
        print(f"[build] {name}: {'compiled' if info['built'] else 'loaded'} "
              f"{info['path']} in {info['seconds']:.2f}s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name} ptxas: {line.strip()}")
    print(f"[build] {len(kernels)} libraries ready in {time.perf_counter() - t0:.2f}s")
    return infos


def phase_parity(torch, kernel, ref, pack) -> tuple[dict, list]:
    """Kernel vs plain version on the card; timings at the slice shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"qgemv": 0.0, "qmatmul": 0.0}
    rows = []
    shapes = list(SLICE_SHAPES) + [(768, RAGGED_N)]
    cases = 0
    for bits in (4, 2, 8):
        for group in (None, 128):
            for (k, n) in shapes:
                w = torch.randn((k, n), generator=gen, device=dev) * 0.02
                wp, s = pack.rtn_pack_leaf(w, bits, group)
                for name, fn, plain, ms in (
                        ("qgemv", kernel.qgemv, ref.qgemv_ref, DECODE_M),
                        ("qmatmul", kernel.qmatmul, ref.qmatmul_ref, PREFILL_M)):
                    for m in ms:
                        x = torch.randn((m, k), generator=gen, device=dev)
                        out = fn(x, wp, s, bits=bits)
                        want = plain(x, wp, s, bits)
                        torch.cuda.synchronize()
                        err = float((out - want).abs().max())
                        tol = tolerance(want)
                        rel = err / max(float(want.abs().max()), 1e-30)
                        cases += 1
                        errs[name] = max(errs[name], err)
                        if not math.isfinite(err) or err > tol:
                            fail(f"{name} W{bits} group={group} M={m} K={k} "
                                 f"N={n}: max abs err {err:.3e} > tol {tol:.3e}")
                        if (k, n) in SLICE_SHAPES and bits in (4, 2) and m in TIMED_M:
                            rows.append(_time_case(torch, name, fn, plain, ref,
                                                   x, wp, s, bits, group, m, k, n,
                                                   err, rel))
    print(f"[parity] {cases} kernel-vs-plain cases within "
          f"1e-4*max|ref|+1e-5; max abs err qgemv {errs['qgemv']:.3e}, "
          f"qmatmul {errs['qmatmul']:.3e}")
    return errs, rows


def _time_case(torch, name, fn, plain, ref, x, wp, s, bits, group, m, k, n,
               err, rel) -> dict:
    from repro_torch.kernels.spec import plan_qgemv, plan_qmatmul

    copies = max(2, math.ceil(L2_FLUSH_BYTES / (wp.numel() + s.numel() * 4)))
    arg_sets = [(x, wp.clone(), s.clone()) for _ in range(copies)]
    t_kernel = graph_time_ms(torch, lambda a, b, c: fn(a, b, c, bits=bits), arg_sets)
    t_plain = graph_time_ms(torch, lambda a, b, c: plain(a, b, c, bits), arg_sets)
    w_deq = ref.dequant(wp, s, bits, k)
    lib_copies = max(2, math.ceil(L2_FLUSH_BYTES / (w_deq.numel() * 4)))
    lib_sets = [(x, w_deq.clone()) for _ in range(lib_copies)]
    t_lib = graph_time_ms(torch, torch.matmul, lib_sets)
    del arg_sets, lib_sets
    plan = (plan_qmatmul(m, k, n, s.shape[0], bits) if name == "qmatmul"
            else plan_qgemv(k, n, s.shape[0], bits))
    b_ms, b_by, b_f32 = bound(m, k, n, bits, s.shape[0], plan.arith)
    row = {"kernel": name, "bits": bits, "group": group, "M": m, "K": k, "N": n,
           "body": plan.body, "tile": plan.tile, "arith": plan.arith, "split": plan.split,
           "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": b_f32,
           "max_abs_err": err, "max_rel_err": rel}
    print(f"[time] {name:7s} W{bits} g={str(group):4s} M={m:3d} K={k:4d} N={n:4d}: "
          f"kernel {t_kernel*1e3:9.2f} us  plain {t_plain*1e3:9.2f} us  "
          f"library {t_lib*1e3:9.2f} us  bound {b_ms*1e3:7.2f} us ({b_by}; f32 "
          f"{b_f32*1e3:.2f})  {plan.body}/{plan.tile} split {plan.split}"
          f"  err {err:.2e} (rel {rel:.2e})")
    return row


def kv_inputs(torch, B, H, K, hd, S, *, seed=0, holes=False, empty_row=False):
    """int8 K/V quantized from random f32 K/V on the card, kpos = arange(S)
    (with -1 holes, or a batch row with no valid slot), cur in [S/4, S)."""
    from repro_torch.kernels.kvattn.ops import quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    k8, v8, ks, vs = quantize_kv(torch.randn((B, S, K, hd), generator=gen, device=dev),
                                 torch.randn((B, S, K, hd), generator=gen, device=dev))
    kpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    if holes:
        kpos[torch.rand((B, S), generator=gen, device=dev) < 0.3] = -1
    if empty_row:
        kpos[0] = -1
    cur = torch.randint(S // 4, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    return q, k8, v8, ks, vs, kpos, cur


def paged_inputs(torch, B, H, K, hd, page_size, max_pages, *, seed=0, holes=False,
                 idle=0):
    """An int8 page pool as the engine stores it (1 + B * max_pages pages of
    codes quantized from random f32 K/V, float16 scales; page 0 the sink),
    block tables (B, max_pages) that give stream b the pages holding
    positions 0..cur_b in a shuffled order and -1 beyond (``holes``: also
    about a third of the pages before; the first ``idle`` rows all -1, idle
    engine slots), q and cur in [S/4, S), S = max_pages * page_size."""
    from repro_torch.kernels.kvattn.ops import quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    P, S = 1 + B * max_pages, max_pages * page_size
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    k8, v8, ks, vs = quantize_kv(
        torch.randn((P, page_size, K, hd), generator=gen, device=dev),
        torch.randn((P, page_size, K, hd), generator=gen, device=dev))
    cache = {"k_pages": k8, "v_pages": v8, "k_scale": ks.half(), "v_scale": vs.half()}
    cur = torch.randint(S // 4, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    order = 1 + torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32)
    bt = order.reshape(B, max_pages).clone()
    page = torch.arange(max_pages, device=dev)[None]
    bt[page > (cur // page_size)[:, None]] = -1
    if holes:
        bt[torch.rand((B, max_pages), generator=gen, device=dev) < 0.3] = -1
    bt[:idle] = -1
    return q, cache, bt.contiguous(), cur


def _kv_bound(q, K, valid, slot, index_bytes, scale_bytes) -> tuple[float, str]:
    """Least time (ms) of one K4 call on this run's data. Bytes: q, cur and
    out moved once, the slot index (kpos or block tables) read once, and the
    codes and scales of the slots the output depends on, each read once
    where rows share it: K and V of every slot valid for some row, V alone
    of every slot of a row with no valid slot (its output is the mean of
    V). Masked slots of a row that has a valid one weigh 0 and are not
    charged. Operations: 4*H*hd f32 a (row, valid slot), 2*H*hd a slot of a
    row with none. ``valid`` (B, S) bool; ``slot`` (B, S) the storage slot
    each row's slot reads."""
    import torch

    B, H, hd = q.shape
    empty = ~valid.any(1)
    k_slots = slot[valid].unique().numel()
    v_slots = torch.cat([slot[valid], slot[empty].reshape(-1)]).unique().numel()
    nbytes = (2 * B * H * hd * 4 + B * 4 + index_bytes
              + (k_slots + v_slots) * K * (hd + scale_bytes))
    ops = H * hd * (4 * int(valid.sum()) + 2 * int(empty.sum()) * valid.shape[1])
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kv_bound(q, kpos, cur, K) -> tuple[float, str]:
    """:func:`_kv_bound` of the dense entry: f32 scales, kpos (B, S) read
    whole, slot (b, t) stored once."""
    import torch

    B, S = kpos.shape
    valid = (kpos >= 0) & (kpos <= cur[:, None])
    slot = torch.arange(B * S, device=kpos.device).reshape(B, S)
    return _kv_bound(q, K, valid, slot, B * S * 4, 4)


def kv_paged_bound(q, bt, cur, K, page_size) -> tuple[float, str]:
    """:func:`_kv_bound` of the paged entry: f16 scales, the block tables
    read whole, slot t of row b stored at page bt[b, t / page_size] (-1:
    page 0, masked), so slots shared by rows (idle rows on page 0) count
    once."""
    import torch

    from repro_torch.kernels.kvattn.ref import paged_view

    B, mp = bt.shape
    _, kpos = paged_view({}, bt, page_size)
    valid = (kpos >= 0) & (kpos <= cur[:, None])
    offs = torch.arange(page_size, device=bt.device)
    slot = (bt.clamp_min(0).long()[..., None] * page_size + offs).reshape(B, -1)
    return _kv_bound(q, K, valid, slot, B * mp * 4, 2)


def _gathered(a, ps):
    """A paged call's operands (q, codes, f16 scales, block tables, cur) as
    the dense operands the engine gathered before the paged entry:
    paged_view's rows and kpos, four gathers, two casts to f32."""
    from repro_torch.kernels.kvattn.ref import paged_view

    q, kp, vp, ks, vs, bt, cur = a
    gather, kpos = paged_view({}, bt, ps)
    return q, gather(kp), gather(vp), gather(ks).float(), gather(vs).float(), kpos, cur


def sdpa_time(torch, F, kv_ref, args) -> tuple[float, float]:
    """The library yardstick of K4 on dense operands: one SDPA call on K/V
    dequantized and expanded to H heads beforehand, the mask added as 0 or
    -1e30 (so a row with no valid slot gets the mean of V, as K4's does).
    Returns its time (ms) and its max abs error against the plain
    version."""
    q, k8, v8, ks, vs, kpos, cur = args
    rep_h = q.shape[1] // k8.shape[2]
    k = (k8.float() * ks[..., None]).repeat_interleave(rep_h, 2).transpose(1, 2)
    v = (v8.float() * vs[..., None]).repeat_interleave(rep_h, 2).transpose(1, 2)
    valid = (kpos >= 0) & (kpos <= cur[:, None])
    mask = torch.where(valid, 0.0, kv_ref.MASK)[:, None, None, :].to(q.dtype)
    copies = max(2, math.ceil(L2_FLUSH_BYTES / (2 * k.numel() * 4)))
    sets = [(q[:, :, None].contiguous(), k.contiguous(), v.contiguous(), mask)
            for _ in range(copies)]
    t_lib = graph_time_ms(
        torch, lambda a, b, c, m: F.scaled_dot_product_attention(a, b, c, attn_mask=m), sets)
    out = F.scaled_dot_product_attention(*sets[0][:3], attn_mask=mask)[:, :, 0]
    return t_lib, float((out - kv_ref.kv_decode_ref(*args)).abs().max())


def phase_kv(torch, kv_kernel, kv_ref) -> tuple[float, dict]:
    """kv_decode vs its plain version on the card; timings at the engine's
    shape and at a long cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.spec import kv_decode_body, plan_kv_decode

    err_max = 0.0
    for (B, H, K, hd, S, window, holes, empty) in KV_CASES:
        args = kv_inputs(torch, B, H, K, hd, S, holes=holes, empty_row=empty)
        before = dict(kv_kernel.BODY_LAUNCHES["kv_decode"])
        got = kv_kernel.kv_decode(*args, window=window)
        body = kv_decode_body(hd)
        if kv_kernel.BODY_LAUNCHES["kv_decode"][body] != before[body] + 1:
            fail(f"kv_decode at hd={hd} did not take its body {body}")
        want = kv_ref.kv_decode_ref(*args, window=window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = tolerance(want)
        err_max = max(err_max, err)
        if not math.isfinite(err) or err > tol:
            fail(f"kv_decode B={B} H={H} K={K} hd={hd} S={S} window={window} "
                 f"holes={holes} empty_row={empty}: max abs err {err:.3e} > "
                 f"tol {tol:.3e}")
    print(f"[kv] {len(KV_CASES)} kernel-vs-plain cases within 1e-4*max|ref|+1e-5; "
          f"max abs err {err_max:.3e}")

    # the paged entry: the dense kernel on the gathered view, bit for bit
    from repro_torch.kernels.spec import kv_plan

    cases = 0
    for (B, H, K, hd, ps, mp, holes, idle) in KV_PAGED_CASES:
        q, pool, bt, cur = paged_inputs(torch, B, H, K, hd, ps, mp, holes=holes, idle=idle)
        paged = (q, pool["k_pages"], pool["v_pages"], pool["k_scale"], pool["v_scale"], bt, cur)
        dense = _gathered(paged, ps)
        want = kv_ref.kv_decode_ref(*dense)
        for plan in (None, kv_plan(hd, H // K, 4, 2)):
            before = dict(kv_kernel.ENTRY_LAUNCHES["kv_decode"])
            got = kv_kernel.kv_decode_paged(*paged, page_size=ps, plan=plan)
            if kv_kernel.ENTRY_LAUNCHES["kv_decode"]["paged"] != before["paged"] + 1:
                fail("kv_decode_paged did not count its launch on the paged entry")
            ref = kv_kernel.kv_decode(*dense, plan=plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            err_max = max(err_max, err)
            cases += 1
            if not torch.equal(got, ref):
                fail(f"paged kv_decode B={B} H={H} K={K} hd={hd} page {ps} x {mp} "
                     f"plan {plan}: not bit-identical to the dense kernel on the "
                     f"gathered view ({float((got - ref).abs().max()):.3e})")
            if not math.isfinite(err) or err > tolerance(want):
                fail(f"paged kv_decode B={B} H={H} K={K} hd={hd} page {ps} x {mp}: "
                     f"max abs err {err:.3e} > tol {tolerance(want):.3e}")
    print(f"[kv] {cases} paged cases bit-identical to the dense kernel on the gathered "
          f"view and within 1e-4*max|ref|+1e-5 of the plain version")

    timed = {}
    for label, (B, H, K, hd, S) in KV_TIMED.items():
        args = kv_inputs(torch, B, H, K, hd, S, seed=1)
        per_set = sum(t.numel() * t.element_size() for t in args)
        copies = max(2, math.ceil(L2_FLUSH_BYTES / per_set))
        arg_sets = [tuple(t.clone() for t in args) for _ in range(copies)]
        t_kernel = graph_time_ms(torch, kv_kernel.kv_decode, arg_sets)
        t_plain = graph_time_ms(torch, kv_ref.kv_decode_ref, arg_sets)
        del arg_sets
        t_lib, lib_err = sdpa_time(torch, F, kv_ref, args)
        b_ms, b_by = kv_bound(args[0], args[5], args[6], K)
        plan = plan_kv_decode(B, K, S, hd, H // K)
        timed[label] = {"B": B, "H": H, "K": K, "hd": hd, "S": S,
                        "body": kv_decode_body(hd), "warps": plan.warps,
                        "split": plan.split, "ms": t_kernel,
                        "plain_ms": t_plain, "library_ms": t_lib,
                        "library_max_abs_err": lib_err, "bound_ms": b_ms,
                        "bound_by": b_by}
        print(f"[time] kv_decode {label:6s} B={B} H={H} K={K} hd={hd:3d} S={S:4d}: "
              f"kernel {t_kernel*1e3:9.2f} us  plain {t_plain*1e3:9.2f} us  "
              f"library {t_lib*1e3:9.2f} us (err {lib_err:.1e})  bound "
              f"{b_ms*1e3:7.2f} us ({b_by})  {plan.warps} warps, split {plan.split}")

    # the paged entry at the engine's decode shape (6 pages of 16 a stream,
    # two idle slots), beside the gather + casts + dense kernel it replaces
    timed["paged"] = _time_paged(torch, F, kv_kernel, kv_ref, 8, 12, 12, 64, 16, 6,
                                 idle=2)
    return err_max, timed



def phase_host(torch, ops, pack) -> dict:
    """Host time per eager call at the decode shape (W4 768x768, M=8): the
    wall time of back-to-back calls, which the host bounds when it is
    slower than the device. ``matmul`` is an FP ``x @ w`` for reference;
    ``kv_*`` one layer's int8 decode read at the engine's shape, through the
    paged entry and through the gather + dense kernel it replaced."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((768, 768), generator=gen, device=dev) * 0.02
    wp, s = pack.rtn_pack_leaf(w, 4, None)
    qw = ops.QuantizedLinear(wp, s, 4, 768)
    x = torch.randn((8, 768), generator=gen, device=dev)

    def per_call_us(fn, n=500):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    host = {"qmm_us": per_call_us(lambda: ops.qmm(x, qw)),
            "matmul_us": per_call_us(lambda: x @ w)}
    print(f"[host] eager call at M=8, 768x768: qmm {host['qmm_us']:.2f} us, "
          f"FP matmul {host['matmul_us']:.2f} us")

    # one layer's int8 decode read at the engine's shape: the paged entry,
    # and the gather + casts + dense kernel the engine ran before it
    from repro_torch.kernels.kvattn import kernel as kv_kernel
    from repro_torch.kernels.kvattn import ops as kv_ops

    q, pool, bt, cur = paged_inputs(torch, 8, 12, 12, 64, 16, 6, seed=2, idle=2)
    paged = (q, pool["k_pages"], pool["v_pages"], pool["k_scale"], pool["v_scale"], bt, cur)
    host["kv_paged_us"] = per_call_us(lambda: kv_ops.attend_int8_paged(q, pool, bt, cur, 16))
    host["kv_gather_dense_us"] = per_call_us(lambda: kv_kernel.kv_decode(*_gathered(paged, 16)))
    print(f"[host] eager int8 decode read at the engine's shape: paged entry "
          f"{host['kv_paged_us']:.2f} us, gather + casts + dense kernel "
          f"{host['kv_gather_dense_us']:.2f} us")
    return host


def phase_serve(torch, kernel, ops, serve, workdir: Path) -> tuple[dict, list]:
    """The main path at full width, W4 and W2; kernel launches counted."""
    from repro_torch.data import Corpus, CorpusConfig
    from repro_torch.deploy import QuantizedArtifact
    from repro_torch.models import get_model

    launches = {"qgemv": 0, "qmatmul": 0}
    results = []
    common = ["--arch", "brecq_lm_100m", "--batch", "8", "--prompt-len", "64",
              "--gen-len", "32", "--seed", "0"]
    for bits in (4, 2):
        art_dir = workdir / f"w{bits}"
        kernel.reset_launches()
        ops.reset_tier_counts()
        first = serve.main([*common, "--quant", str(bits),
                            "--save-artifact", str(art_dir)])
        again = serve.main([*common, "--artifact", str(art_dir),
                            "--no-compare-fp"])
        run = dict(kernel.LAUNCHES)
        bodies = dict(kernel.BODY_LAUNCHES["qmatmul"])
        dec_bodies = dict(kernel.BODY_LAUNCHES["qgemv"])
        for k in launches:
            launches[k] += run[k]
        tiers = first["stats"]["qmm_tiers"]
        print(f"[serve W{bits}] kernel launches {run}; qmatmul bodies {bodies}; qgemv "
              f"bodies {dec_bodies}; qmm tiers {tiers}")
        if run["qgemv"] == 0 or run["qmatmul"] == 0:
            fail(f"W{bits} serve did not launch both kernels: {run}")
        if bodies["tc"] != run["qmatmul"]:
            fail(f"W{bits} prefill did not all take the tensor cores: {bodies}")
        if dec_bodies["gemv_tc"] != run["qgemv"]:
            fail(f"W{bits} decode did not all take the tensor-core decode body: "
                 f"{dec_bodies}")
        if tiers["decode"] == 0 or tiers["prefill"] == 0:
            fail(f"W{bits} serve did not dispatch both tiers: {tiers}")
        if not torch.equal(first["tokens"], again["tokens"]):
            fail(f"W{bits}: serving the reloaded artifact gave other tokens")

        # replay the kernel path's tokens through the plain version
        cfg, model = get_model("brecq_lm_100m")
        art = QuantizedArtifact.load(str(art_dir)).to("cuda")
        prompts = Corpus(CorpusConfig(vocab=cfg.vocab)).sample(8, 64, seed=7)
        batch = {"tokens": torch.from_numpy(prompts).cuda()}
        # 12 layers x 7 packed matmuls compound the per-matmul f32 order error
        err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch,
                                           first["tokens"], f"W{bits}")
        st = first["stats"]
        print(f"[serve W{bits}] logits kernel vs plain: max abs err {err:.3e} "
              f"(tol {tol:.3e}); greedy token agreement {agree:.4f}; artifact "
              f"{first['artifact_bytes']} B vs fp {first['fp_bytes']} B; "
              f"prefill {st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['tok_s']:.1f} tok/s (fp: prefill "
              f"{first['fp_stats']['prefill_tok_s']:.1f}, decode "
              f"{first['fp_stats']['tok_s']:.1f})")
        results.append({"bits": bits, "launches": run, "bodies": bodies,
                        "qgemv_bodies": dec_bodies,
                        "qmm_tiers": tiers,
                        "logits_max_abs_err": err, "token_agreement": agree,
                        "artifact_bytes": first["artifact_bytes"],
                        "fp_bytes": first["fp_bytes"], "stats": st,
                        "fp_stats": first["fp_stats"]})
    return launches, results


def replay_logits(torch, model, params, batch, gen, backend):
    """Prefill ``batch``, then decode the served tokens ``gen`` (B, T)
    teacher-forced, with packed matmuls on ``backend``: logits (B, T, V)."""
    from repro_torch.models.common import NO_QUANT

    hook = copy.copy(NO_QUANT)  # NO_QUANT is a shared singleton
    hook.packed_backend = backend
    b, s = batch["tokens"].shape
    with torch.inference_mode():
        cache = model.init_cache(b, s + gen.shape[1], torch.float32, "cuda")
        step, cache = model.prefill(params, batch, cache, hook)
        steps = [step]
        for i in range(gen.shape[1] - 1):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            step, cache = model.decode_step(params, gen[:, i:i + 1], cache, pos, hook)
            steps.append(step)
    return torch.stack(steps, 1)


def _kernel_vs_plain(torch, model, params, batch, gen, what):
    """Replay the served tokens through the kernels and the plain versions:
    logits within 1e-3 * max|logit|, and the kernel path's greedy tokens
    are the served ones. Returns (max abs err, limit, token agreement)."""
    got = replay_logits(torch, model, params, batch, gen, "cuda")
    want = replay_logits(torch, model, params, batch, gen, "torch")
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not bool(torch.isfinite(got).all()) or err > tol:
        fail(f"{what}: kernel-path logits differ from the plain path by "
             f"{err:.3e} > {tol:.3e}")
    if not torch.equal(got.argmax(-1), gen.long()):
        fail(f"{what}: replayed kernel-path logits do not reproduce the "
             f"served tokens")
    return err, tol, agree


def _counted(kernels, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    returns (fn's result, the counts just after, the packed matmuls'
    launches by body just after)."""
    for k in kernels.values():
        k.reset_launches()
    out = fn()
    counts, bodies = {}, {}
    for k in kernels.values():
        counts.update(k.LAUNCHES)
        bodies.update(copy.deepcopy(getattr(k, "BODY_LAUNCHES", {})))
        for by in ("ENTRY", "SPLIT"):  # kv_decode's launches by entry and by split
            for name, d in getattr(k, f"{by}_LAUNCHES", {}).items():
                bodies[f"{name}_{by.lower()}"] = dict(d)
    return out, counts, bodies


def engine_params(torch, model, seed: int = 0):
    """Full-width random weights from ``seed``, with the linear weights at
    3x their init range and the embedding at std 0.5, as the CPU engine
    tests make them: at the init's own scale greedy decode settles on one
    repeated token per stream, which would make the token checks blind."""
    def scale(tree, key=""):
        if isinstance(tree, dict):
            return {k: scale(v, k) for k, v in tree.items()}
        return tree * {"w": 3.0, "table": 25.0}.get(key, 1.0)

    return scale(model.init(torch.Generator(device="cuda").manual_seed(seed)))


@contextlib.contextmanager
def _attend_wrapped(wrap):
    """Serve with ``kernels.kvattn.ops.attend_int8_paged`` replaced by
    ``wrap(attend_int8_paged)`` (``paged_attend`` looks it up on every
    single-token int8 read)."""
    from repro_torch.kernels.kvattn import ops as kv_ops

    orig = kv_ops.attend_int8_paged
    kv_ops.attend_int8_paged = wrap(orig)
    try:
        yield
    finally:
        kv_ops.attend_int8_paged = orig


def _shadowed(log: dict):
    """attend_int8_paged that also runs the plain version (the gathered
    view and kv_decode_ref) on the same inputs, the engine's own pool and
    block tables, and logs the worst error against the kernel tolerance."""
    def wrap(orig):
        def attend(*a, **kw):
            out = orig(*a, **kw)
            want = orig(*a, **{**kw, "backend": "torch"})
            err = float((out - want).abs().max())
            log["calls"] += 1
            log["max_abs_err"] = max(log["max_abs_err"], err)
            log["worst_err_over_tol"] = max(log["worst_err_over_tol"],
                                            err / tolerance(want))
            return out
        return attend
    return wrap


def _newest_key_dropped(orig):
    """A wrong kernel, to read what the logits limit catches: the query
    does not see the key it has just appended (an off-by-one mask)."""
    return lambda q, cache, bt, cur, ps, **kw: orig(q, cache, bt, cur - 1, ps, **kw)


def _engine(serve, model, art, args, streams, backend, sequential=False, **over):
    """One engine over ``art`` serving ``streams`` (staggered, or one
    request at a time), kernels or plain versions, logits recorded;
    ``over`` replaces EngineConfig fields."""
    from repro_torch.serve_engine import ServeEngine

    hook = copy.copy(art.hook())  # NO_QUANT is a shared singleton
    hook.packed_backend = backend
    eng = ServeEngine(model, art.params, serve.engine_config(
        args, art.manifest, backend=backend, record_logits=True, **over),
        quant=hook)
    if sequential:
        for uid, (_, prompt, max_new) in enumerate(streams):
            eng.submit(prompt, max_new, uid=uid)
            eng.run()
    else:
        serve.drive_engine(eng, streams)
    eng.assert_no_leaks()
    return eng


def _tokens(eng) -> dict:
    return {u: list(r.generated) for u, r in eng.requests.items()}


def _logits(eng) -> dict:
    import numpy as np

    return {u: np.stack(r.logits) for u, r in eng.requests.items()}


def _agree(a, b, uids=None) -> dict:
    """Hold engine ``a``'s recorded logits against ``b``'s, stream by
    stream, over the steps whose token histories agree: up to and including
    the first step where the greedy tokens differ. At that step both chose
    on the same history, so the two top logits of either lie within twice
    the logits' difference: a token that differs is a near tie that the
    logits check bounds. Returns the max abs difference, ``b``'s max
    |logit|, the steps compared of all, and {uid: first differing step}."""
    import numpy as np

    la, lb, ta, tb = _logits(a), _logits(b), _tokens(a), _tokens(b)
    uids = list(la) if uids is None else uids
    out = {"max_abs_err": 0.0, "steps": 0, "of": 0, "diverged": {},
           "max_abs": max(float(np.abs(x).max()) for x in lb.values())}
    for u in uids:
        if a.requests[u].state != "done" or b.requests[u].state != "done":
            fail(f"stream {u} did not finish: {a.requests[u].state}, "
                 f"{b.requests[u].state}")
        if not np.isfinite(la[u]).all():
            fail(f"non-finite logits for stream {u}")
        n = len(tb[u])
        d = next((i for i in range(n) if ta[u][i] != tb[u][i]), n)
        if d < n:
            out["diverged"][u] = d
        upto = min(d + 1, n)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float(np.abs(la[u][:upto] - lb[u][:upto]).max()))
        out["steps"] += upto
        out["of"] += n
    return out


def _say(what: str, r: dict) -> str:
    return (f"{what}: logits max abs err {r['max_abs_err']:.3e} "
            f"({r['max_abs_err'] / r['max_abs']:.3e} of max |logit| "
            f"{r['max_abs']:.3e}) over {r['steps']} of {r['of']} steps; "
            f"tokens part in {len(r['diverged'])} streams (first differing "
            f"steps {sorted(r['diverged'].values())})")


def phase_engine(torch, serve, kernels, workdir: Path) -> tuple[dict, dict]:
    """The serve engine at full width through the main entry point, then
    the same schedule through kernels vs plain versions (int8 and float32
    pools, and a wrong kernel), staggered vs sequential, and under page
    pressure."""
    import numpy as np

    from repro_torch.deploy import QuantizedArtifact
    from repro_torch.models import get_model

    cfg, model = get_model("brecq_lm_100m")
    params = engine_params(torch, model)
    art_dir = workdir / "engine_w4"
    main_args = [*ENGINE_ARGS, "--save-artifact", str(art_dir)]
    out, launches, bodies = _counted(kernels, lambda: serve.main(main_args, params=params))
    m = out["metrics"]
    print(f"[engine] main path: kernel launches {launches}; qmatmul bodies "
          f"{bodies['qmatmul']}; qgemv bodies {bodies['qgemv']}; kv_decode bodies "
          f"{bodies['kv_decode']}, entries {bodies['kv_decode_entry']}, splits "
          f"{bodies['kv_decode_split']}")
    if min(launches[k] for k in ("qgemv", "qmatmul", "kv_decode")) == 0:
        fail(f"the engine's main path did not launch every kernel: {launches}")
    if bodies["qmatmul"]["tc"] != launches["qmatmul"]:
        fail(f"the engine's prefill chunks did not all take the tensor cores: {bodies}")
    if bodies["qgemv"]["gemv_tc"] != launches["qgemv"]:
        fail(f"the engine's decode steps did not all take the tensor-core decode "
             f"body: {bodies['qgemv']}")
    if bodies["kv_decode"]["v16"] != launches["kv_decode"]:
        fail(f"the engine's kv_decode (hd 64) left the 16-byte body: {bodies['kv_decode']}")
    if bodies["kv_decode_entry"]["paged"] != launches["kv_decode"]:
        fail(f"the engine's decode reads did not all take the paged entry: "
             f"{bodies['kv_decode_entry']}")
    if set(out["states"].values()) != {"done"}:
        fail(f"engine requests did not all finish: {out['states']}")
    distinct = sorted(len(set(t)) for t in out["tokens"].values())
    print(f"[engine] distinct tokens per stream: {distinct}")
    if np.median(distinct) < MIN_DISTINCT_TOKENS:
        fail(f"the streams' greedy tokens hardly vary ({distinct}): the token "
             f"checks below would be blind")

    args = serve.parse_args(main_args)
    art = QuantizedArtifact.load(str(art_dir)).to("cuda")
    streams = serve.engine_streams(args, cfg.vocab)

    # kernels vs plain versions, int8 pool; every kv_decode call of the
    # kernel run is also held against its plain version on its own inputs
    shadow = {"calls": 0, "max_abs_err": 0.0, "worst_err_over_tol": 0.0}
    with _attend_wrapped(_shadowed(shadow)):
        kern = _engine(serve, model, art, args, streams, "cuda")
    if _tokens(kern) != out["tokens"]:
        fail("the engine replay through the kernels gave other tokens than "
             "the main path")
    print(f"[engine] kv_decode vs plain on the engine's inputs: "
          f"{shadow['calls']} calls, max abs err {shadow['max_abs_err']:.3e}, "
          f"worst err/tol {shadow['worst_err_over_tol']:.3f}")
    if shadow["calls"] == 0 or shadow["worst_err_over_tol"] > 1.0:
        fail(f"kv_decode vs its plain version on the engine's own pool: {shadow}")
    vs_plain = _agree(kern, _engine(serve, model, art, args, streams, "torch"))
    print(f"[engine] {_say('kernel vs plain path, int8 pool', vs_plain)}")

    # control: float32 pools hold no codes to flip
    vs_plain32 = _agree(
        _engine(serve, model, art, args, streams, "cuda", kv_dtype="float32"),
        _engine(serve, model, art, args, streams, "torch", kv_dtype="float32"))
    print(f"[engine] {_say('kernel vs plain path, float32 pool', vs_plain32)}")

    # what a wrong kernel gives: the limit must tell it from code flips
    with _attend_wrapped(_newest_key_dropped):
        wrong = _agree(_engine(serve, model, art, args, streams, "cuda"), kern)
    print(f"[engine] {_say('a kv_decode that drops the newest key', wrong)}")

    four = streams[:4]
    stag = _engine(serve, model, art, args, four, "cuda")
    seq = _engine(serve, model, art, args, four, "cuda", sequential=True)
    ls, lq = _logits(stag), _logits(seq)
    if not (all(np.array_equal(ls[u], lq[u]) for u in ls)
            and _tokens(stag) == _tokens(seq)):
        fail("staggered and sequential serving of 4 streams differ on the card")
    print(f"[engine] staggered == sequential for 4 streams: tokens and logits "
          f"bit-identical ({stag.metrics()['ticks']} vs "
          f"{seq.metrics()['ticks']} ticks)")

    pargs = serve.parse_args([*main_args, "--overcommit", "prompt",
                              "--num-pages", str(PRESSURE_PAGES)])
    press = _engine(serve, model, art, pargs, streams, "cuda")
    pm = press.metrics()
    hit = [u for u, r in press.requests.items() if r.preemptions]
    lp, lk = _logits(press), _logits(kern)
    same = [u for u in lp if u not in hit and np.array_equal(lp[u], lk[u])
            and _tokens(press)[u] == _tokens(kern)[u]]
    resumed = _agree(press, kern, hit)
    print(f"[engine] pressured ({PRESSURE_PAGES} pages, overcommit prompt): "
          f"{pm['preemptions']} preemptions of {len(hit)} streams, "
          f"{pm['replay_prefill_chunks']} replay chunks; {len(same)} of "
          f"{len(lp) - len(hit)} other streams bit-identical to the unpressured "
          f"run; {_say('preempted streams vs the unpressured run', resumed)}")

    tol = ENGINE_LOGIT_TOL * vs_plain["max_abs"]
    for what, r, limit in (("kernel vs plain path, int8 pool", vs_plain, tol),
                           ("preempted streams vs the unpressured run", resumed, tol),
                           ("kernel vs plain path, float32 pool", vs_plain32,
                            1e-3 * vs_plain32["max_abs"])):
        if r["max_abs_err"] > limit:
            fail(f"engine logits, {what}: {r['max_abs_err']:.3e} > {limit:.3e}")
        if r["steps"] < MIN_STEPS_SHARED * r["of"]:
            fail(f"engine, {what}: only {r['steps']} of {r['of']} steps on a "
                 f"shared token history")
    if wrong["max_abs_err"] <= tol:
        fail(f"the logits limit {tol:.3e} does not catch a wrong kernel "
             f"({wrong['max_abs_err']:.3e})")
    if pm["preemptions"] < 1:
        fail(f"{PRESSURE_PAGES} pages forced no preemption")
    if len(same) != len(lp) - len(hit):
        fail("a stream that was never preempted served other tokens or logits "
             "under pressure")
    print(f"[engine] sustained {m['sustained_tok_s']:.1f} tok/s, mean slot "
          f"occupancy {m['mean_slot_occupancy']:.3f}, resident KV "
          f"{m['mean_resident_kv_bytes_per_stream']:.0f} B/stream, "
          f"{m['bytes_per_page']} B/page, kv_decode launches "
          f"{launches['kv_decode']}")
    return (launches, bodies), {"metrics": m, "launches": launches, "bodies": bodies,
                      "distinct_tokens_per_stream": distinct,
                      "kv_decode_on_engine_inputs": shadow,
                      "kernel_vs_plain_int8": vs_plain,
                      "kernel_vs_plain_float32": vs_plain32,
                      "wrong_kernel_vs_kernel": wrong,
                      "preempted_vs_unpressured": resumed,
                      "logits_limit": tol, "pressure_metrics": pm,
                      "preempted_uids": hit}


def phase_engine_long(torch, serve, kernels, workdir: Path) -> dict:
    """The serve engine at full width and depth over a long context,
    through the main entry point: 8 slots, 8 streams of prompts up to 2016
    tokens (S_cap 2048), int8 pool; every kv_decode launch on the paged
    entry with S split over a cluster. Then the same schedule through the
    kernels with every kv read shadowed by its plain version (tokens equal
    to the main path's), and through the plain versions (logits within
    ENGINE_LOGIT_TOL of max |logit| on the shared token history)."""
    import numpy as np

    from repro_torch.deploy import QuantizedArtifact
    from repro_torch.kernels.spec import plan_kv_decode
    from repro_torch.models import get_model

    cfg, model = get_model("brecq_lm_100m")
    params = engine_params(torch, model)
    art_dir = workdir / "engine_long_w4"
    main_args = [*LONG_ENGINE_ARGS, "--save-artifact", str(art_dir)]
    out, launches, bodies = _counted(kernels, lambda: serve.main(main_args, params=params))
    m = out["metrics"]
    args = serve.parse_args(main_args)
    ecfg = serve.engine_config(args, {})
    s_cap = ecfg.page_size * -(-ecfg.max_len // ecfg.page_size)
    plan = plan_kv_decode(ecfg.num_slots, cfg.n_kv_heads, s_cap, cfg.d_model // cfg.n_heads)
    entries, splits = bodies["kv_decode_entry"], bodies["kv_decode_split"]
    print(f"[engine long] main path: {ecfg.num_pages} pages of {ecfg.page_size} (S_cap "
          f"{s_cap}), kernel launches {launches}; kv_decode entries {entries}, splits "
          f"{splits} (plan: {plan.warps} warps, split {plan.split}); "
          f"{m['tokens_generated']} tokens in {m['wall_s']:.2f}s "
          f"({m['sustained_tok_s']:.1f} tok/s sustained), occupancy "
          f"{m['mean_slot_occupancy']:.3f}, resident KV "
          f"{m['mean_resident_kv_bytes_per_stream']:.0f} B/stream")
    if min(launches[k] for k in ("qgemv", "qmatmul", "kv_decode")) == 0:
        fail(f"the long-context engine did not launch every kernel: {launches}")
    if entries["paged"] != launches["kv_decode"]:
        fail(f"the long-context engine's decode reads left the paged entry: {entries}")
    if splits[1] or plan.split == 1:
        fail(f"the long-context engine's kv_decode launches did not split S: {splits}")
    if set(out["states"].values()) != {"done"}:
        fail(f"long-context engine requests did not all finish: {out['states']}")
    distinct = sorted(len(set(t)) for t in out["tokens"].values())
    if np.median(distinct) < MIN_DISTINCT_TOKENS:
        fail(f"the long-context streams' greedy tokens hardly vary ({distinct})")

    art = QuantizedArtifact.load(str(art_dir)).to("cuda")
    streams = serve.engine_streams(args, cfg.vocab)
    shadow = {"calls": 0, "max_abs_err": 0.0, "worst_err_over_tol": 0.0}
    with _attend_wrapped(_shadowed(shadow)):
        kern = _engine(serve, model, art, args, streams, "cuda")
    if _tokens(kern) != out["tokens"]:
        fail("the long-context replay through the kernels gave other tokens than the "
             "main path")
    print(f"[engine long] kv_decode vs plain on the engine's inputs: {shadow['calls']} "
          f"calls, max abs err {shadow['max_abs_err']:.3e}, worst err/tol "
          f"{shadow['worst_err_over_tol']:.3f}")
    if shadow["calls"] == 0 or shadow["worst_err_over_tol"] > 1.0:
        fail(f"long-context kv_decode vs its plain version on the engine's pool: {shadow}")
    vs_plain = _agree(kern, _engine(serve, model, art, args, streams, "torch"))
    tol = ENGINE_LOGIT_TOL * vs_plain["max_abs"]
    print(f"[engine long] {_say('kernel vs plain path, int8 pool', vs_plain)} (limit "
          f"{tol:.3e})")
    if vs_plain["max_abs_err"] > tol:
        fail(f"long-context engine logits, kernel vs plain: {vs_plain['max_abs_err']:.3e} "
             f"> {tol:.3e}")
    if vs_plain["steps"] < MIN_STEPS_SHARED * vs_plain["of"]:
        fail(f"long-context engine: only {vs_plain['steps']} of {vs_plain['of']} steps on "
             f"a shared token history")
    return {"metrics": m, "launches": launches, "bodies": bodies, "s_cap": s_cap,
            "plan": plan._asdict(), "distinct_tokens_per_stream": distinct,
            "kv_decode_on_engine_inputs": shadow, "kernel_vs_plain_int8": vs_plain,
            "logits_limit": tol}


def grouped_plain(ref, x, wp, s, bits):
    """The plain grouped version ``qmm`` picks: one expert at a time up to
    8 rows per expert, one (E, K, N) dequant above."""
    fn = ref.qmm_grouped_ref if x.shape[1] <= 8 else ref.qmm_grouped_dense_ref
    return fn(x, wp, s, bits)


AUDIT_LIMIT_S = 30.0  # the audit phase's own budget
AUDIT_BYTES_TOL = 0.01  # recorded weight bytes against the packed leaves' nbytes


def _kernel_counts(kernels: dict) -> dict:
    """Every launch counter of the kernel modules, copied."""
    names = ("LAUNCHES", "BODY_LAUNCHES", "ENTRY_LAUNCHES", "SPLIT_LAUNCHES",
             "VIEW_LAUNCHES")
    return {(k, n): copy.deepcopy(getattr(m, n)) for k, m in kernels.items()
            for n in names if hasattr(m, n)}


def _restore_counts(kernels: dict, saved: dict) -> None:
    for (k, n), value in saved.items():
        counts = getattr(kernels[k], n)
        counts.clear()
        counts.update(value)


def _step_wall_ms(torch, fn, reps: int) -> float:
    """Mean wall of ``fn()`` over ``reps`` calls after one warm-up, between
    CUDA events (the host's dispatch included, as a served step pays it)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_audit(torch, kernels: dict) -> dict:
    """The program audit and two step summaries on the card (module doc,
    audit). Launches made here are taken back out of the kernels' counts."""
    from repro_torch.analysis.audit.program_check import build_programs
    from repro_torch.analysis.audit.rules import AuditProgram, run_program_rules
    from repro_torch.analysis.optrace import analyze_step
    from repro_torch.analysis.roofline import from_step, ideal_serve_bytes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    saved = _kernel_counts(kernels)
    out: dict = {}
    try:
        progs, violations = build_programs("quick", with_calib=True, device="cuda")
        log, skipped = [], []
        violations += run_program_rules(progs, verbose=log.append, skipped=skipped)
        for prog in progs:
            for rule, why in prog.suppress.items():
                print(f"[audit] suppressed {rule} on {prog.name}: {why}")
        ran = len(progs) * 4 - len(skipped)
        print(f"[audit] {len(progs)} programs on the card under the four program rules "
              f"({ran} checks, {len(skipped)} skipped; no_host_transfer under "
              f"set_sync_debug_mode('error')): {len(violations)} violation(s)")
        for v in violations:
            print(f"[audit] {v}")
        if violations:
            fail(f"the program audit found {len(violations)} violation(s) that are "
                 f"not suppressed on the card: {violations[0]}")
        seeded = AuditProgram("seeded_cpu_copy", lambda x: (x * 2).cpu(),
                              (torch.ones(4, device="cuda"),))
        found = run_program_rules([seeded], rules=("no_host_transfer",))
        print(f"[audit] seeded .cpu() of a CUDA tensor: {[str(v) for v in found]}")
        if not found:
            fail("no_host_transfer did not fire on a program that copies a CUDA "
                 "tensor to the CPU")
        out["programs"] = [p.name for p in progs]
        out["suppressed"] = {f"{p.name}:{r}": why for p in progs
                             for r, why in p.suppress.items()}
        out["checks"], out["violations"] = ran, len(violations)
        out["seeded"] = [str(v) for v in found]

        # the two steps of the fixed batch, brecq-lm-100m at full width, RTN W4
        cfg, model = get_model("brecq_lm_100m")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        art = rtn_artifact(params, 4, cfg=cfg)
        del params
        hook = art.hook()
        B, P, G = 8, 64, 32
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
        cache = model.init_cache(B, P + G, torch.float32, "cuda")
        tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
        pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
        packed = sum(n["w"].nbytes + n["qscale"].nbytes for n in _packed_nodes(art.params))
        steps = {"prefill": (lambda: model.prefill(art.params, {"tokens": prompts}, cache,
                                                   hook), ShapeSpec("audit_prefill", P, B,
                                                                    "prefill"), 5),
                 "decode": (lambda: model.decode_step(art.params, tok, cache, pos, hook),
                            ShapeSpec("audit_decode", P + G, B, "decode"), 20)}
        for name, (fn, shape, reps) in steps.items():
            with torch.inference_mode():
                summary = analyze_step(fn)
                wall = _step_wall_ms(torch, fn, reps)
            roof = from_step(summary, cfg, shape, 1, w_bits=4)
            bound_ms = max(roof.compute_s, roof.memory_s, roof.collective_s) * 1e3
            ideal = ideal_serve_bytes(cfg, shape, 1, w_bits=4)
            rec = {"flops": summary.flops, "bytes": summary.bytes,
                   "weight_bytes": summary.weight_bytes, "launches": summary.launches,
                   "bottleneck": roof.bottleneck, "bound_ms": bound_ms,
                   "mem_frac": roof.mem_frac, "ideal_serve_bytes": ideal,
                   "wall_ms": wall, "wall_over_bound": wall / bound_ms,
                   "top_ops": dict(list(summary.by_op.items())[:6])}
            out[name] = rec
            print(f"[audit] {name} (brecq_lm_100m full, RTN W4, {B} x "
                  f"{P if name == 'prefill' else 1}): flops {summary.flops:.6e} bytes "
                  f"{summary.bytes:.6e} (packed weights {summary.weight_bytes:.0f}) "
                  f"bottleneck {roof.bottleneck} bound {bound_ms * 1e3:.2f} us mem_frac "
                  f"{roof.mem_frac:.4f} (ideal_serve_bytes {ideal:.6e}) wall "
                  f"{wall:.3f} ms ({wall / bound_ms:.1f}x the bound); launches "
                  f"{summary.launches}")
        got = out["decode"]["weight_bytes"]
        print(f"[audit] decode weight bytes recorded {got:.0f} vs the packed leaves' "
              f"nbytes {packed} (w and qscale; limit {AUDIT_BYTES_TOL:.0%})")
        if abs(got - packed) > AUDIT_BYTES_TOL * packed:
            fail(f"the decode step's recorded weight bytes {got:.0f} are not within "
                 f"{AUDIT_BYTES_TOL:.0%} of the packed leaves' {packed}")
        out["packed_leaf_bytes"] = packed
        del art, cache
        torch.cuda.empty_cache()
    finally:
        _restore_counts(kernels, saved)
    out["seconds"] = time.perf_counter() - t0
    print(f"[audit] the phase took {out['seconds']:.1f}s (limit {AUDIT_LIMIT_S:.0f}s)")
    if out["seconds"] > AUDIT_LIMIT_S:
        fail(f"the audit phase took {out['seconds']:.1f}s, over its {AUDIT_LIMIT_S}s")
    return out


def _packed_nodes(tree) -> list:
    """Every packed node (``w`` beside ``qscale``) of a params tree."""
    if not isinstance(tree, dict):
        return []
    found = [tree] if "qscale" in tree else []
    return found + [n for v in tree.values() for n in _packed_nodes(v)]


def phase_moe_kernel(torch, kernel, ref, pack) -> tuple[float, list]:
    """qmatmul_grouped vs its plain versions at deepseek-moe-16b's expert
    shapes, a wrong kernel caught, and timings per MoE layer."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    err_max, cases, rows, wrong = 0.0, 0, [], None
    for bits, group, k, n in MOE_CASES:
        w = torch.randn((MOE_E, k, n), generator=gen, device=dev) * 0.02
        wp, s = pack.rtn_pack_leaf(w, bits, group)
        del w
        cbits = pack.container_bits(bits, k)
        for m in MOE_PARITY_M:
            x = torch.randn((MOE_E, m, k), generator=gen, device=dev)
            out = kernel.qmatmul_grouped(x, wp, s, bits=cbits)
            want = grouped_plain(ref, x, wp, s, cbits)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            tol = tolerance(want)
            cases += 1
            err_max = max(err_max, err)
            if not math.isfinite(err) or err > tol:
                fail(f"qmatmul_grouped W{bits} group={group} E={MOE_E} M={m} "
                     f"K={k} N={n}: max abs err {err:.3e} > tol {tol:.3e}")
            served = bits == 4 and group is None and (k, n) in MOE_SHAPES
            if served and m == 8 and wrong is None:
                # a wrong kernel: every expert reads expert 0's scales
                bad = kernel.qmatmul_grouped(x, wp, s[:1].expand_as(s).contiguous(),
                                             bits=cbits)
                wrong = float((bad - want).abs().max())
                print(f"[moe] a qmatmul_grouped that reads expert 0's scales for "
                      f"every expert: max abs err {wrong:.3e} (tol {tol:.3e})")
                if wrong <= tol:
                    fail(f"the K3 tolerance {tol:.3e} does not catch a wrong "
                         f"kernel ({wrong:.3e})")
            if served and m in MOE_TIMED_M:
                rows.append(_time_grouped(torch, kernel, ref, pack, x, wp, s, m,
                                          k, n, err, float(want.abs().max())))
    print(f"[moe] {cases} qmatmul_grouped-vs-plain cases within "
          f"1e-4*max|ref|+1e-5; max abs err {err_max:.3e}")
    return err_max, rows


def _time_grouped(torch, kernel, ref, pack, x, wp, s, m, k, n, err, amax) -> dict:
    from repro_torch.kernels.spec import plan_qmatmul

    copies = max(2, math.ceil(L2_FLUSH_BYTES / (wp.numel() + s.numel() * 4)))
    arg_sets = [(x, wp.clone(), s.clone()) for _ in range(copies)]
    t_kernel = graph_time_ms(
        torch, lambda a, b, c: kernel.qmatmul_grouped(a, b, c, bits=4), arg_sets)
    t_plain = graph_time_ms(torch, lambda a, b, c: grouped_plain(ref, a, b, c, 4),
                            arg_sets)
    del arg_sets
    w_deq = pack.dequant_leaf(wp, s, k)  # (E, K, N) f32
    lib_copies = max(2, math.ceil(L2_FLUSH_BYTES / (w_deq.numel() * 4)))
    lib_sets = [(x, w_deq.clone()) for _ in range(lib_copies)]
    t_lib = graph_time_ms(torch, torch.bmm, lib_sets)
    del lib_sets, w_deq
    plan = plan_qmatmul(m, k, n, s.shape[1], 4, MOE_E, True)
    b_ms, b_by, b_f32 = bound(m, k, n, 4, s.shape[1], plan.arith)
    b_ms, b_f32 = b_ms * MOE_E, b_f32 * MOE_E  # E independent products of one shape
    row = {"kernel": "qmatmul_grouped", "bits": 4, "group": None, "E": MOE_E,
           "M": m, "K": k, "N": n, "body": plan.body, "tile": plan.tile,
           "arith": plan.arith,
           "split": plan.split, "ms": t_kernel, "plain_ms": t_plain,
           "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
           "bound_f32_ms": b_f32, "max_abs_err": err,
           "max_rel_err": err / max(amax, 1e-30)}
    print(f"[time] qmatmul_grouped W4 E={MOE_E} M={m:2d} K={k:4d} N={n:4d}: kernel "
          f"{t_kernel*1e3:9.2f} us  plain {t_plain*1e3:9.2f} us  library "
          f"{t_lib*1e3:9.2f} us  bound {b_ms*1e3:7.2f} us ({b_by}; f32 {b_f32*1e3:.2f})  "
          f"{plan.body}/{plan.tile} split {plan.split}  err {err:.2e}")
    return row


@contextlib.contextmanager
def _dropped_at_prefill(moe_mod, log: list):
    """Count, for every MoE call on more than one token, the (token,
    expert) picks that capacity routing drops (``log`` = [dropped, all])."""
    orig = moe_mod.apply

    def apply(ctx, p, spec, x):
        if x.shape[1] > 1:
            dropped, picks = moe_mod.dropped_picks(ctx, p, spec, x)
            log[0] += dropped
            log[1] += picks
        return orig(ctx, p, spec, x)

    moe_mod.apply = apply
    try:
        yield
    finally:
        moe_mod.apply = orig


def phase_moe_serve(torch, serve, kernels, workdir: Path) -> dict:
    """deepseek-moe-16b at full width, depth cut to 4 layers, W4, capacity
    routing, through the fixed-batch path and the engine."""
    import numpy as np

    from repro_torch.data import Corpus, CorpusConfig
    from repro_torch.deploy import QuantizedArtifact, rtn_artifact, tree_bytes
    from repro_torch.models import build_model, get_config
    from repro_torch.models import moe as moe_mod

    cfg = dataclasses.replace(get_config("deepseek_moe_16b"), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    n_moe = MOE_LAYERS - cfg.moe.first_k_dense
    if model.moe_impl != "capacity":
        fail(f"deepseek-moe-16b routes by {model.moe_impl!r}, not capacity")
    t0 = time.perf_counter()
    params = engine_params(torch, model)
    fp_bytes = tree_bytes(params)
    art_dir = workdir / "moe_w4"
    rtn_artifact(params, 4, None, cfg=cfg).save(str(art_dir))
    del params
    torch.cuda.empty_cache()
    art = QuantizedArtifact.load(str(art_dir), verify=True).to("cuda")
    serve._check_manifest(art.manifest, cfg)
    art_bytes = art.nbytes()
    print(f"[moe] {cfg.name} at full width, {MOE_LAYERS} layers ({n_moe} MoE, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"{cfg.moe.n_shared} shared): W4 artifact {art_bytes} B vs fp "
          f"{fp_bytes} B ({art_bytes / fp_bytes:.3f}x); made, saved and loaded "
          f"verified in {time.perf_counter() - t0:.1f}s")

    # fixed batch: the main path, kernel launches counted
    prompts = Corpus(CorpusConfig(vocab=cfg.vocab)).sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    (gen, st), launches, bodies = _counted(kernels, lambda: serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag="moe W4"))
    forwards = 2 + 32  # warm-up prefill and decode step, prefill, 31 decode steps
    print(f"[moe serve] kernel launches {launches}; qmm tiers {st['qmm_tiers']}; "
          f"qmatmul_grouped bodies {bodies['qmatmul_grouped']}")
    gb = bodies["qmatmul_grouped"]
    if gb["tc"] != 3 * n_moe * 2 or gb["gemv_tc"] != 3 * n_moe * (forwards - 2):
        fail(f"the MoE prefills (64 rows an expert) did not take the tensor cores "
             f"and the decode steps the tensor-core decode body: {gb}")
    if launches["qmatmul_grouped"] != 3 * n_moe * forwards:
        fail(f"qmatmul_grouped launched {launches['qmatmul_grouped']} times, not "
             f"3 x {n_moe} MoE layers x {forwards} forwards")
    if st["qmm_tiers"]["grouped"] == 0 or min(
            launches[k] for k in ("qgemv", "qmatmul", "qmatmul_grouped")) == 0:
        fail(f"the MoE serve missed a kernel or the grouped tier: {launches}, "
             f"{st['qmm_tiers']}")
    drops = [0, 0]
    with _dropped_at_prefill(moe_mod, drops):
        err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen,
                                           "moe W4")
    distinct = sorted(len(set(row.tolist())) for row in gen)
    print(f"[moe serve] logits kernel vs plain: max abs err {err:.3e} (tol "
          f"{tol:.3e}); greedy token agreement {agree:.4f}; distinct tokens per "
          f"sequence {distinct}; prefill {st['prefill_tok_s']:.1f} tok/s, decode "
          f"{st['tok_s']:.1f} tok/s; capacity dropped {drops[0]} of {drops[1]} "
          f"(token, expert) picks at prefill ({drops[0] // 2} per pass)")
    fixed = {"launches": launches, "bodies": bodies, "stats": st,
             "logits_max_abs_err": err,
             "token_agreement": agree, "distinct_tokens_per_sequence": distinct,
             "dropped_picks_per_prefill": drops[0] // 2,
             "picks_per_prefill": drops[1] // 2, "artifact_bytes": art_bytes,
             "fp_bytes": fp_bytes}

    # the engine: 8 slots over an int8 pool, launches counted
    args = serve.parse_args(["--arch", "deepseek_moe_16b", "--quant", "4", "--engine",
                             "--batch", "8", "--prompt-len", "64", "--gen-len", "32",
                             "--seed", "0", "--kv-dtype", "int8", "--streams",
                             str(MOE_ENGINE_STREAMS)])
    streams = serve.engine_streams(args, cfg.vocab)
    eng, elaunch, ebodies = _counted(kernels, lambda: _engine(serve, model, art, args,
                                                              streams, "cuda"))
    m = eng.metrics()
    edistinct = sorted(len(set(t)) for t in _tokens(eng).values())
    print(f"[moe engine] kernel launches {elaunch}, grouped bodies "
          f"{ebodies['qmatmul_grouped']}, kv_decode entries {ebodies['kv_decode_entry']}; "
          f"{m['tokens_generated']} tokens "
          f"in {m['wall_s']:.2f}s ({m['sustained_tok_s']:.1f} tok/s sustained), "
          f"occupancy {m['mean_slot_occupancy']:.3f}, resident KV "
          f"{m['mean_resident_kv_bytes_per_stream']:.0f} B/stream; distinct "
          f"tokens per stream {edistinct}")
    if min(elaunch.values()) == 0:
        fail(f"the MoE engine did not launch every kernel: {elaunch}")
    if ebodies["qmatmul_grouped"]["gemv"] or ebodies["qgemv"]["gemv"]:
        fail(f"the MoE engine left the tensor-core decode body: {ebodies}")
    if ebodies["kv_decode_entry"]["paged"] != elaunch["kv_decode"]:
        fail(f"the MoE engine's decode reads did not all take the paged entry: "
             f"{ebodies['kv_decode_entry']}")
    four = streams[:4]
    stag = _engine(serve, model, art, args, four, "cuda")
    seq = _engine(serve, model, art, args, four, "cuda", sequential=True)
    ls, lq = _logits(stag), _logits(seq)
    if not (all(np.array_equal(ls[u], lq[u]) for u in ls)
            and _tokens(stag) == _tokens(seq)):
        fail("MoE engine: staggered and sequential serving of 4 streams differ")
    print(f"[moe engine] staggered == sequential for 4 streams: tokens and logits "
          f"bit-identical ({stag.metrics()['ticks']} vs {seq.metrics()['ticks']} "
          f"ticks)")
    return {"fixed": fixed, "engine": {"metrics": m, "launches": elaunch,
                                       "bodies": ebodies,
                                       "distinct_tokens_per_stream": edistinct}}


def fq_bound(k: int, n: int, s_rows: int) -> tuple[float, str]:
    """Least time (ms) of one fakequant call on (k, n) f32 weights: w and v
    read once, the (s_rows, n) scale read once, the output written once,
    against 7 f32 operations per weight (divide, floor, compare, add, two
    clip compares, multiply)."""
    t_bytes = fq_work(k, n, s_rows).bytes / HBM_BW * 1e3
    t_ops = 7 * k * n / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fq_kernel(torch, fq_kernel, fq_ref) -> tuple[float, list]:
    """K5 vs its plain version on the card: hard bit for bit, soft within
    1e-6 * max|ref|; a kernel that clips at qmax - 1 must be caught; times
    of the hardened forward (W2, (1, N) scales) at the block's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    soft_err, cases, rows = 0.0, 0, []
    for bits in (2, 4):
        qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        for (k, n) in FQ_SHAPES:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            v = torch.randn((k, n), generator=gen, device=dev) * 2
            s_row = torch.clamp_min(w.abs().amax(0, keepdim=True) / qmax, 1e-8)
            jitter = torch.rand((k, n), generator=gen, device=dev) + 0.5
            for s in (s_row, (s_row * jitter).contiguous()):
                for hard in (True, False):
                    out = fq_kernel.fakequant(w, v, s, qmin=qmin, qmax=qmax, hard=hard)
                    bad = fq_kernel.fakequant(w, v, s, qmin=qmin, qmax=qmax - 1,
                                              hard=hard)
                    want = fq_ref.fakequant_ref(w, v, s, qmin, qmax, hard)
                    torch.cuda.synchronize()
                    what = (f"fakequant W{bits} {'hard' if hard else 'soft'} "
                            f"K={k} N={n} scale {tuple(s.shape)}")
                    tol = 1e-6 * float(want.abs().max())
                    err = float((out - want).abs().max())
                    bad_err = float((bad - want).abs().max())
                    cases += 1
                    if hard and not torch.equal(out, want):
                        fail(f"{what}: not bit-identical to the plain version "
                             f"(max abs err {err:.3e})")
                    if not math.isfinite(err) or err > tol:
                        fail(f"{what}: max abs err {err:.3e} > tol {tol:.3e}")
                    if (hard and torch.equal(bad, want)) or bad_err <= tol:
                        fail(f"{what}: a kernel clipping at qmax - 1 passes the "
                             f"check (err {bad_err:.3e})")
                    if not hard:
                        soft_err = max(soft_err, err)
                    if (k, n) in SLICE_SHAPES and bits == 2 and hard and s is s_row:
                        rows.append(_time_fq(torch, fq_kernel, fq_ref, w, v, s,
                                             qmin, qmax))
    print(f"[fakequant] {cases} kernel-vs-plain cases: hard bit-identical, soft "
          f"max abs err {soft_err:.3e} (limit 1e-6*max|ref|); a kernel clipping "
          f"at qmax - 1 caught in every case")
    return soft_err, rows


def _time_fq(torch, fq_kernel, fq_ref, w, v, s, qmin, qmax) -> dict:
    k, n = w.shape
    copies = max(2, math.ceil(L2_FLUSH_BYTES / (3 * w.numel() * 4)))
    sets = [(w.clone(), v.clone(), s) for _ in range(copies)]
    t_kernel = graph_time_ms(torch, lambda a, b, c: fq_kernel.fakequant(
        a, b, c, qmin=qmin, qmax=qmax, hard=True), sets)
    t_plain = graph_time_ms(torch, lambda a, b, c: fq_ref.fakequant_ref(
        a, b, c, qmin, qmax, True), sets)
    del sets
    b_ms, b_by = fq_bound(k, n, s.shape[0])
    print(f"[time] fakequant hard W2 K={k:4d} N={n:4d}: kernel {t_kernel*1e3:8.2f} us  "
          f"plain {t_plain*1e3:8.2f} us  bound {b_ms*1e3:6.2f} us ({b_by})")
    return {"K": k, "N": n, "ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by}


def _shadowed_fq(torch, fq_kernel, fq_ref, log: dict):
    """K5 with every call held against its plain version on the call's own
    inputs (bit for bit when hard)."""
    orig = fq_kernel.fakequant

    def fn(w, v, scale, *, qmin, qmax, hard):
        out = orig(w, v, scale, qmin=qmin, qmax=qmax, hard=hard)
        want = fq_ref.fakequant_ref(w, v, scale, qmin, qmax, hard)
        log["calls"] += 1
        if not (torch.equal(out, want) if hard else
                float((out - want).abs().max()) <= 1e-6 * float(want.abs().max())):
            log["mismatches"] += 1
        return out

    return orig, fn


def _counted_fq(torch, fq_kernel, fq_ref, qm_kernel, fn):
    """Run ``fn`` with every K5 call shadowed by its plain version; returns
    (fn's result, K5 launches, shadow log, the packed matmuls' launches,
    wall seconds, device peak bytes)."""
    shadow = {"calls": 0, "mismatches": 0}
    orig, fq_kernel.fakequant = _shadowed_fq(torch, fq_kernel, fq_ref, shadow)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in (fq_kernel, qm_kernel):
            k.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fq_kernel.LAUNCHES["fakequant"]
        others = dict(qm_kernel.LAUNCHES)
    finally:
        fq_kernel.fakequant = orig
    return out, launches, shadow, others, wall, torch.cuda.max_memory_allocated()


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic CUDA algorithms (cuBLAS's fixed workspace is set before
    CUDA starts, in ``main``), for the train phase only."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _recorded_steps(train):
    """Every training step's loss and host time (the step ends in a sync),
    recorded around ``train.train_step``, which ``main`` looks up on its
    module at every step; yields (losses, seconds)."""
    losses, secs = [], []
    step_fn = train.train_step

    def recorded(*a, **kw):
        t0 = time.perf_counter()
        out = step_fn(*a, **kw)
        losses.append(float(out[2]))
        secs.append(time.perf_counter() - t0)
        return out

    train.train_step = recorded
    try:
        yield losses, secs
    finally:
        train.train_step = step_fn


def _ckpt_leaves(directory: Path) -> tuple:
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.interop import flatten_paths

    cm = CheckpointManager(str(directory))
    return cm.latest_step(), flatten_paths(cm.restore_nested(cm.latest_step()))


@contextlib.contextmanager
def _sigterm_at(train, step: int):
    """SIGTERM delivered to this process during training step ``step``
    (counted from the run's first), through ``train.train_step``."""
    step_fn, calls = train.train_step, [0]

    def signalled(*a, **kw):
        calls[0] += 1
        if calls[0] == step:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(*a, **kw)

    train.train_step = signalled
    try:
        yield
    finally:
        train.train_step = step_fn


def _train_run(torch, train, args) -> tuple:
    """``train.main(args)`` with its steps recorded and the device peak
    taken: (params, losses, seconds a step, peak bytes)."""
    torch.cuda.reset_peak_memory_stats()
    with _recorded_steps(train) as (losses, secs):
        params = train.main(args)
        torch.cuda.synchronize()
    return params, losses, secs, torch.cuda.max_memory_allocated()


def _median_ms(secs) -> float:
    return sorted(secs)[len(secs) // 2] * 1e3


def phase_train(torch, workdir: Path) -> tuple:
    """brecq-lm-100m trained at full width and depth through
    ``repro_torch.launch.train.main``, with deterministic CUDA algorithms.
    First RESUME_STEPS under the CLI's defaults (``--remat dots``): a run
    stopped by SIGTERM (checkpointed at the next step) and resumed by a
    second call equals an unbroken one bit for bit, every param and Adam
    moment; the same steps under ``--remat none`` equal them too. Then the
    run the model is trained by (TRAIN_ARGS); the FP loss on the held-out
    batches below HELDOUT_FP_MAX. Returns the trained params and the
    phase's record."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.evaluate import evaluate
    from repro_torch.launch import train
    from repro_torch.models import get_model

    t_phase = time.perf_counter()
    cfg, model = get_model("brecq_lm_100m")
    n_params = (cfg.n_layers * (4 * cfg.d_model ** 2 + 3 * cfg.d_model * cfg.d_ff)
                + cfg.vocab * cfg.d_model)
    stop, steps = RESUME_STEPS
    short = ["--steps", str(steps), "--log-every", "1000", "--ckpt-every", "1000"]
    dirs = {k: workdir / f"train_{k}" for k in ("unbroken", "resumed", "none")}
    remat = {}
    with _deterministic(torch):
        _, _, secs, peak = _train_run(torch, train, [*short, "--ckpt-dir",
                                                     str(dirs["unbroken"])])
        remat["dots"] = {"step_ms_median": _median_ms(secs), "device_peak_bytes": peak}
        with _sigterm_at(train, stop):
            train.main([*short, "--ckpt-dir", str(dirs["resumed"])])
        stopped_at = CheckpointManager(str(dirs["resumed"])).all_steps()
        train.main([*short, "--ckpt-dir", str(dirs["resumed"])])
        _, _, secs, peak = _train_run(torch, train, [*short, "--remat", "none",
                                                     "--ckpt-dir", str(dirs["none"])])
        remat["none"] = {"step_ms_median": _median_ms(secs), "device_peak_bytes": peak}
        leaves = {k: _ckpt_leaves(d) for k, d in dirs.items()}
        want_step, want = leaves["unbroken"]
        if stopped_at != [stop]:
            fail(f"SIGTERM during step {stop} left checkpoints {stopped_at}")
        for k in ("resumed", "none"):
            got_step, got = leaves[k]
            differ = sorted(n for n in want if n not in got or not torch.equal(want[n], got[n]))
            if got_step != want_step or set(got) != set(want) or differ:
                fail(f"the {k} run's {steps} steps differ from the unbroken --remat dots "
                     f"run's: step {got_step} / {want_step}, leaves {differ[:8]}")
        n_leaves = len(want)
        n_moments = sum(k.startswith(("opt/m/", "opt/v/")) for k in want)
        del leaves, want
        print(f"[train] {steps} unbroken steps (--remat dots) == stopped by SIGTERM at "
              f"step {stop} (checkpoint {stopped_at}) and resumed, == --remat none: bit "
              f"for bit on all {n_leaves} leaves ({n_moments} Adam moments); a step "
              f"{remat['dots']['step_ms_median']:.2f} ms with dots (device peak "
              f"{remat['dots']['device_peak_bytes']} B), "
              f"{remat['none']['step_ms_median']:.2f} ms with none (peak "
              f"{remat['none']['device_peak_bytes']} B)")

        metrics = workdir / "train_metrics.json"
        t0 = time.perf_counter()
        params, losses, secs, peak = _train_run(torch, train, [
            *TRAIN_ARGS, "--ckpt-dir", str(workdir / "train"), "--metrics-out", str(metrics)])
        wall = time.perf_counter() - t0
    m = json.loads(metrics.read_text())
    kept = CheckpointManager(str(workdir / "train")).all_steps()
    tokens = 16 * 128
    # 6 N T for the weight matmuls (the tied head included) + 12 L B S^2 d
    # for attention's two batched products, forward and backward
    flop = 6 * n_params * tokens + 12 * cfg.n_layers * 16 * 128 ** 2 * cfg.d_model
    step_ms = _median_ms(secs)
    fp = evaluate(model, params, _quality_batches(torch, cfg))
    print(f"[train] {cfg.name} full width and depth ({n_params} params), {TRAIN_ARGS}: "
          f"{m['steps']} steps of 16 x 128 tokens in {wall:.2f}s (wall_s "
          f"{m['wall_s']:.2f}); a step: median {step_ms:.2f} ms, mean "
          f"{1e3 * sum(secs) / len(secs):.2f} ms, first {secs[0] * 1e3:.2f} ms; "
          f"{flop / 1e12:.3f} TFLOP a step, {flop / step_ms / 1e9:.2f} TFLOP/s at the "
          f"median; loss {losses[0]:.4f} -> {losses[-1]:.4f}; device peak {peak} B; "
          f"checkpoints kept {kept}; stragglers {m['stragglers']}; held-out "
          f"({QUALITY_BATCHES}x{HELDOUT_SEQS}x{CALIB_LEN}) FP loss {fp['loss']:.4f} (ln "
          f"vocab {math.log(cfg.vocab):.4f}), top1 {fp['top1']:.4f}")
    if m["steps"] != TRAIN_STEPS or kept[-1] != TRAIN_STEPS:
        fail(f"training ran {m['steps']} steps, checkpoints {kept}")
    if not math.isfinite(fp["loss"]) or fp["loss"] >= HELDOUT_FP_MAX:
        fail(f"the trained model did not learn: held-out FP loss {fp['loss']:.4f} >= "
             f"{HELDOUT_FP_MAX}")
    return params, {
        "args": TRAIN_ARGS, "steps": m["steps"], "wall_s": wall, "metrics": m,
        "step_ms_median": step_ms, "step_ms_mean": 1e3 * sum(secs) / len(secs),
        "step_ms_first": secs[0] * 1e3, "flop_a_step": flop,
        "loss_first": losses[0], "loss_final": losses[-1],
        "loss_curve": losses[::50] + losses[-1:], "device_peak_bytes": peak,
        "checkpoints_kept": kept, "heldout_fp": fp, "n_params": n_params,
        "resume": {"steps": steps, "sigterm_at": stop, "stopped_checkpoints": stopped_at,
                   "leaves": n_leaves, "moments": n_moments, "bit_for_bit": True},
        "remat": remat, "phase_wall_s": time.perf_counter() - t_phase}


def phase_calib(torch, fq_kernel, fq_ref, qm_kernel, serve, params,
                workdir: Path) -> tuple:
    """BRECQ calibration of the trained brecq-lm-100m (``params``, from the
    train phase) at full width and depth through ``repro_torch.core.quantize``
    at W2 and W4, K5 launches counted and shadowed; the quality gates (BRECQ
    W2 closer to FP than RTN W2 in held-out logits MSE and eval loss); export,
    load and serve of the W2 artifact; the W4 artifact exported and served
    through ``serve.main --artifact``. Returns what the ``mixed`` phase
    reuses (model, weights, the W2 and W4 results, batches) and the phase's
    record."""
    from repro_torch.core import ReconConfig, quantize, rtn_on_scales
    from repro_torch.core.evaluate import evaluate
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.models import get_model

    cfg, model = get_model("brecq_lm_100m")
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    calib = make_batches(corpus, CALIB_SEQS // 8, 8, CALIB_LEN, seed=1)
    held = {k: t.cuda() for k, t in
            make_batches(corpus, 1, HELDOUT_SEQS, CALIB_LEN, seed=2)[0].items()}
    rc = ReconConfig(w_bits=2, iters=CALIB_ITERS, calib_bs=8)

    # the calibration path runs K5 only
    res, launches, shadow, others, wall, peak = _counted_fq(
        torch, fq_kernel, fq_ref, qm_kernel, lambda: quantize(model, params, calib, rc))
    st = res.stats
    retries = st["unit_retries"]
    expect = cfg.n_layers * 2 * 7 + cfg.n_layers * 7 + 14 * retries
    print(f"[calib] {cfg.name} full width and depth ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}), W2, {CALIB_SEQS}x{CALIB_LEN} tokens, iters "
          f"{rc.iters}, calib_bs {rc.calib_bs}: calib_wall_s {st['calib_wall_s']:.2f}, "
          f"fisher_wall_s {st['fisher_wall_s']:.2f}, calib_iters_per_s "
          f"{st['calib_iters_per_s']:.1f}, calib_peak_bytes {st['calib_peak_bytes']} "
          f"(device peak {peak} B); wall {wall:.2f}s")
    print(f"[calib] fakequant launches {launches} (expected {expect} = "
          f"{cfg.n_layers} units x 2 hard programs x 7 + {cfg.n_layers * 7} in bake "
          f"+ 14 x {retries} retries); shadowed "
          f"calls {shadow['calls']}, mismatches {shadow['mismatches']}; unit "
          f"retries {retries}, fallbacks {st['unit_fallbacks']}, OOM halvings "
          f"{st['unit_oom_halvings']}; unit cache {st['unit_cache']}")
    if launches != expect:
        fail(f"calibration launched fakequant {launches} times, expected {expect}")
    if any(others.values()):
        fail(f"calibration launched packed-matmul kernels: {others}")
    if shadow["mismatches"] or shadow["calls"] != launches:
        fail(f"fakequant against its plain version during calibration: {shadow}")
    for u in st["units"]:
        print(f"[calib] unit {u['unit']}: rtn_recon_mse {u['rtn_recon_mse']:.4e} "
              f"final_recon_mse {u['final_recon_mse']:.4e} loss {u['loss_first']:.4e}"
              f" -> {u['loss_last']:.4e} retries {u['retries']} fallback "
              f"{u['fallback']}")

    # W4, counted and shadowed as W2
    rc4 = ReconConfig(w_bits=4, iters=CALIB_W4_ITERS, calib_bs=8)
    res4, launches4, shadow4, others4, wall4, _ = _counted_fq(
        torch, fq_kernel, fq_ref, qm_kernel, lambda: quantize(model, params, calib, rc4))
    expect4, _ = _fq_expected(model, res4)
    print(f"[calib] W4: calib_wall_s {res4.stats['calib_wall_s']:.2f}; fakequant launches "
          f"{launches4} (expected {expect4}); shadowed calls {shadow4['calls']}, "
          f"mismatches {shadow4['mismatches']}; unit retries "
          f"{res4.stats['unit_retries']}; wall {wall4:.2f}s")
    if launches4 != expect4 or any(others4.values()):
        fail(f"the W4 calibration launched fakequant {launches4} times (expected "
             f"{expect4}), packed matmuls {others4}")
    if shadow4["mismatches"] or shadow4["calls"] != launches4:
        fail(f"fakequant against its plain version during the W4 calibration: {shadow4}")

    # quality on QUALITY_BATCHES held-out batches: eval loss, and logits MSE
    # against FP (the mean over the batches' equal-sized logits)
    qbatches = _quality_batches(torch, cfg)
    quality = {"fp": evaluate(model, params, qbatches)}
    with torch.no_grad():
        fps = [model.forward(params, b)[0] for b in qbatches]
        for bits, r in ((2, res), (4, res4)):
            rtn_params = rtn_on_scales(model, params, r, held)
            for name, p in ((f"brecq_w{bits}", r.params_q), (f"rtn_w{bits}", rtn_params)):
                quality[name] = {**evaluate(model, p, qbatches), "logits_mse": sum(
                    _logits_mse(torch, model, fp, b, p) for fp, b in zip(fps, qbatches))
                    / len(qbatches)}
            del rtn_params
        quality["fp_logits_mean_square"] = sum(float(torch.mean(fp ** 2))
                                               for fp in fps) / len(fps)
    del fps
    mse = {"brecq": quality["brecq_w2"]["logits_mse"], "rtn": quality["rtn_w2"]["logits_mse"]}
    for bits in (2, 4):
        b, r = quality[f"brecq_w{bits}"], quality[f"rtn_w{bits}"]
        print(f"[calib] held-out ({QUALITY_BATCHES}x{HELDOUT_SEQS}x{CALIB_LEN}) W{bits}: "
              f"eval loss FP {quality['fp']['loss']:.4f}, BRECQ {b['loss']:.4f}, RTN "
              f"{r['loss']:.4f}; "
              f"logits MSE vs FP BRECQ {b['logits_mse']:.4e}, RTN {r['logits_mse']:.4e} "
              f"(ratio {b['logits_mse'] / r['logits_mse']:.4f}); top1 FP "
              f"{quality['fp']['top1']:.4f}, BRECQ {b['top1']:.4f}, RTN {r['top1']:.4f}")
    w2b, w2r = quality["brecq_w2"], quality["rtn_w2"]
    if not all(math.isfinite(x) for x in (w2b["loss"], w2r["loss"], *mse.values())):
        fail(f"held-out quality is not finite: {quality}")
    if mse["brecq"] >= mse["rtn"] or w2b["loss"] >= w2r["loss"]:
        fail(f"BRECQ-W2 is not closer to FP than RTN-W2: logits MSE {mse}, eval loss "
             f"{w2b['loss']} vs {w2r['loss']}")

    # export, save, load; dequantized block weights are params_q bit for bit
    art, n_blocks = _export_verified(torch, model, res, serve, workdir / "calib_w2",
                                     "calib W2")
    print(f"[calib] artifact {art.nbytes()} B saved and loaded verified; the "
          f"{n_blocks} block weights equal params_q bit for bit")
    prompts = corpus.sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    qm_kernel.reset_launches()
    gen_toks, sst = serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag="calib W2")
    served = dict(qm_kernel.LAUNCHES)
    if served["qgemv"] == 0 or served["qmatmul"] == 0:
        fail(f"serving the calibrated artifact missed a kernel: {served}")
    if qm_kernel.BODY_LAUNCHES["qgemv"]["gemv_tc"] != served["qgemv"]:
        fail(f"serving the calibrated artifact left the tensor-core decode body: "
             f"{qm_kernel.BODY_LAUNCHES['qgemv']}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen_toks,
                                       "calib W2")
    print(f"[calib serve] kernel launches {served}; logits kernel vs plain: max abs "
          f"err {err:.3e} (tol {tol:.3e}); greedy token agreement {agree:.4f}; "
          f"prefill {sst['prefill_tok_s']:.1f} tok/s, decode {sst['tok_s']:.1f} tok/s")
    w4 = _serve_trained_w4(torch, model, res4, qm_kernel, serve, workdir)
    keep = ("calib_wall_s", "fisher_wall_s", "calib_iters_per_s", "calib_peak_bytes",
            "calib_peak_bytes_detail", "unit_retries", "unit_fallbacks",
            "unit_oom_halvings", "unit_cache")
    reuse = {"model": model, "params": params, "res": res, "res4": res4, "calib": calib,
             "held": held, "prompts": prompts, "quality": quality}
    return reuse, {"launches": launches, "expected_launches": expect, "shadow": shadow,
            "stats": {k: st[k] for k in keep}, "device_peak_bytes": peak,
            "wall_s": wall, "logits_mse": mse, "quality": quality,
            "w4": {"launches": launches4, "expected_launches": expect4, "shadow": shadow4,
                   "stats": {k: res4.stats[k] for k in keep}, "wall_s": wall4,
                   "serve": w4},
            "units": [{k: u[k] for k in ("unit", "rtn_recon_mse", "final_recon_mse",
                                         "loss_first", "loss_last", "retries",
                                         "fallback", "opt_wall_s")}
                      for u in st["units"]],
            "serve": {"launches": served, "logits_max_abs_err": err,
                      "token_agreement": agree, "stats": sst}}


def phase_baselines(torch, fq_kernel, reuse: dict) -> dict:
    """The paper's PTQ baselines (``repro_torch.core.baselines``) on the
    trained brecq-lm-100m at full width and depth, on the calib phase's
    calibration set: at W2 and W4 min-max RTN, OMSE (RTN on MSE scales),
    bias correction, AdaQuant (BASELINE_ADAQUANT_ITERS a layer) and LAPQ
    (one round over the default ratios), and RTN W2A4 (min-max activation
    scales); each row's held-out eval loss, top-1, logits MSE against FP
    and wall, beside the calib phase's BRECQ and ``rtn_on_scales`` rows.
    Gates: every eval loss finite; BRECQ W2 below min-max RTN W2 and bias
    correction W2 in eval loss (the paper's Table 2 at its robust end)."""
    from repro_torch.core.baselines import (quantize_adaquant, quantize_bias_correction,
                                            quantize_lapq, quantize_rtn)
    from repro_torch.core.evaluate import evaluate
    from repro_torch.core.hooks import ServeHook
    from repro_torch.models.common import NO_QUANT

    t_phase = time.perf_counter()
    model, params, calib, quality = (reuse[k] for k in ("model", "params", "calib",
                                                        "quality"))
    qbatches = _quality_batches(torch, model.cfg)
    with torch.no_grad():
        fps = [model.forward(params, b)[0] for b in qbatches]
    methods = {
        "rtn_minmax": lambda b: quantize_rtn(model, params, calib, b, scale_method="minmax"),
        "omse": lambda b: quantize_rtn(model, params, calib, b, scale_method="mse"),
        "biascorr": lambda b: quantize_bias_correction(model, params, calib, b),
        "adaquant": lambda b: quantize_adaquant(model, params, calib, b,
                                                iters=BASELINE_ADAQUANT_ITERS),
        "lapq": lambda b: quantize_lapq(model, params, calib, b),
    }
    runs = [(f"{m}_w{b}", fn, b, None) for b in (2, 4) for m, fn in methods.items()]
    runs.append(("rtn_w2a4", lambda b: quantize_rtn(model, params, calib, b, a_bits=4),
                 2, 4))
    rows = {}
    fq_kernel.reset_launches()
    for name, fn, bits, a_bits in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pq, scales = fn(bits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hook = ServeHook(scales, a_bits) if a_bits else NO_QUANT
        with torch.no_grad():
            mse = sum(float(torch.mean((model.forward(pq, b, hook)[0] - fp) ** 2))
                      for fp, b in zip(fps, qbatches)) / len(qbatches)
        rows[name] = {**evaluate(model, pq, qbatches, scales or None, a_bits),
                      "logits_mse": mse, "wall_s": wall}
        print(f"[baselines] {name}: eval loss {rows[name]['loss']:.4f}, top1 "
              f"{rows[name]['top1']:.4f}, logits MSE vs FP {mse:.4e}, wall {wall:.2f}s")
        del pq
    del fps
    launches = dict(fq_kernel.LAUNCHES)
    fp = quality["fp"]
    beside = {"fp": fp, **{f"{m}_w{b}": quality[f"{k}_w{b}"] for b in (2, 4)
                           for m, k in (("brecq", "brecq"), ("rtn_on_scales", "rtn"))}}
    print(f"[baselines] held-out {QUALITY_BATCHES}x{HELDOUT_SEQS}x{CALIB_LEN} tokens "
          f"(calib phase's rows beside): name, eval loss, minus FP, top1, logits MSE")
    for name, r in {**beside, **rows}.items():
        print(f"[baselines]   {name:<16} {r['loss']:.4f} {r['loss'] - fp['loss']:+.4f} "
              f"{r['top1']:.4f} {r.get('logits_mse', 0.0):.4e}")
    bad = [n for n, r in rows.items() if not math.isfinite(r["loss"])]
    if bad:
        fail(f"baselines with a non-finite eval loss: {bad}")
    brecq2 = quality["brecq_w2"]["loss"]
    for name in ("rtn_minmax_w2", "biascorr_w2"):
        if brecq2 >= rows[name]["loss"]:
            fail(f"BRECQ W2's eval loss {brecq2} is not below {name}'s "
                 f"{rows[name]['loss']}")
    omse_gap = rows["omse_w2"]["loss"] - quality["rtn_w2"]["loss"]
    print(f"[baselines] BRECQ W2 {brecq2:.4f} below min-max RTN W2 by "
          f"{rows['rtn_minmax_w2']['loss'] - brecq2:.4f} and bias correction W2 by "
          f"{rows['biascorr_w2']['loss'] - brecq2:.4f} nats (gated); OMSE W2 minus "
          f"rtn_on_scales W2 {omse_gap:+.6f} nats; fakequant launches {launches}; "
          f"phase wall {time.perf_counter() - t_phase:.2f}s")
    return {"rows": rows, "beside": beside, "omse_minus_rtn_on_scales_w2": omse_gap,
            "launches": launches, "phase_wall_s": time.perf_counter() - t_phase}


def _serve_trained_w4(torch, model, res4, qm_kernel, serve, workdir: Path) -> dict:
    """The trained model's W4 artifact exported, saved and loaded verified,
    then served through ``serve.main --artifact`` (batch 8, prompt 64, gen
    32): K1 and K2 both launched, every launch on the tensor-core bodies;
    the plain path replays the served tokens."""
    from repro_torch.data import Corpus, CorpusConfig

    art_dir = workdir / "trained_w4"
    art, n_blocks = _export_verified(torch, model, res4, serve, art_dir, "trained W4")
    args = ["--arch", "brecq_lm_100m", "--artifact", str(art_dir), "--batch", "8",
            "--prompt-len", "64", "--gen-len", "32", "--seed", "0", "--no-compare-fp"]
    out, served, bodies = _counted({"qmatmul": qm_kernel}, lambda: serve.main(args))
    if served["qgemv"] == 0 or served["qmatmul"] == 0:
        fail(f"serving the trained W4 artifact missed a kernel: {served}")
    if (bodies["qgemv"]["gemv_tc"] != served["qgemv"]
            or bodies["qmatmul"]["tc"] != served["qmatmul"]):
        fail(f"serving the trained W4 artifact left the tensor-core bodies: {bodies}")
    prompts = Corpus(CorpusConfig(vocab=model.cfg.vocab)).sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, out["tokens"],
                                       "trained W4")
    st = out["stats"]
    distinct = len(torch.unique(out["tokens"]))
    print(f"[train serve W4] artifact {art.nbytes()} B ({n_blocks} block weights equal "
          f"params_q bit for bit); kernel launches {served}; logits kernel vs plain: max "
          f"abs err {err:.3e} (tol {tol:.3e}); greedy token agreement {agree:.4f}; "
          f"{distinct} distinct tokens; prefill {st['prefill_tok_s']:.1f} tok/s, decode "
          f"{st['tok_s']:.1f} tok/s")
    return {"launches": served, "bodies": {k: bodies[k] for k in ("qgemv", "qmatmul")},
            "logits_max_abs_err": err, "logits_tol": tol, "token_agreement": agree,
            "distinct_tokens": distinct, "artifact_bytes": art.nbytes(), "stats": st}


def _fq_expected(model, res) -> tuple[int, int]:
    """K5 launches of one ``quantize`` run (all, and those on stacks of
    experts): each unit's hard forward at the RTN start and after every
    try, then ``bake``'s one per weight with calibrated logits."""
    from repro_torch.core.reconstruction import Walker

    walker = Walker(model)
    total = experts = 0
    for u in res.stats["units"]:
        if u.get("skipped"):
            continue
        tries = 2 + u["retries"]
        for bi in u["unit"]:
            prefix = walker.block_path(bi) + "/"
            paths = [p for p in res.qstates if p.startswith(prefix)]
            total += tries * len(paths)
            experts += tries * sum(res.qstates[p][0].scale.ndim == 3 for p in paths)
    return (total + len(res.v),
            experts + sum(v.ndim == 3 for v in res.v.values()))


def _quality_batches(torch, cfg) -> list:
    """QUALITY_BATCHES held-out batches of HELDOUT_SEQS x CALIB_LEN (seed 2:
    the first is every phase's ``held``), on the card."""
    from repro_torch.data import Corpus, CorpusConfig, make_batches

    return [{k: t.cuda() for k, t in b.items()} for b in make_batches(
        Corpus(CorpusConfig(vocab=cfg.vocab)), QUALITY_BATCHES, HELDOUT_SEQS, CALIB_LEN,
        seed=2)]


def _logits_mse(torch, model, fp, held, params_q) -> float:
    with torch.no_grad():
        return float(torch.mean((model.forward(params_q, held)[0] - fp) ** 2))


def _export_verified(torch, model, res, serve, art_dir: Path, what: str):
    """Export ``res``, save it, load it verified onto the card, and hold every
    block weight of the loaded artifact, dequantized, against ``params_q``
    bit for bit. Returns (the artifact, the number of block weights)."""
    from repro_torch.deploy import QuantizedArtifact, dequant_leaf, export

    export(model, res).save(str(art_dir))
    art = QuantizedArtifact.load(str(art_dir), verify=True).to("cuda")
    serve._check_manifest(art.manifest, model.cfg)
    blocks = [p for p in res.qstates if "." in p.split("/")[0]]
    for path in blocks:
        sname, ri = path.split("/")[0].rsplit(".", 1)
        node, qnode = art.params[sname], res.params_q[sname]
        for k in path.split("/")[1:]:
            node, qnode = node[k], qnode[k]
        want = qnode["w"][int(ri)]
        if not torch.equal(dequant_leaf(node["w"][int(ri)], node["qscale"][int(ri)],
                                        want.shape[0]), want):
            fail(f"the loaded {what} artifact's {path} differs from params_q")
    return art, len(blocks)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def phase_calib_moe(torch, fq_kernel, fq_ref, qm_kernel, serve, workdir: Path) -> dict:
    """BRECQ W2 calibration of deepseek-moe-16b at full width (4 layers)
    through ``repro_torch.core.quantize``: every K5 call shadowed, its
    launches on stacks of experts counted apart; BRECQ against RTN on
    held-out logits; export, verified load and a fixed batch served
    through qmatmul_grouped, replayed by the plain path."""
    from repro_torch.core import ReconConfig, quantize, reconstruction, rtn_on_scales
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.deploy import QuantizedArtifact, export
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config("deepseek_moe_16b"), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    n_moe = MOE_LAYERS - cfg.moe.first_k_dense
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    calib = make_batches(corpus, MOE_CALIB_SEQS // 8, 8, CALIB_LEN, seed=1)
    held = {k: t.cuda() for k, t in
            make_batches(corpus, 1, HELDOUT_SEQS, CALIB_LEN, seed=2)[0].items()}
    rc = ReconConfig(w_bits=2, iters=MOE_CALIB_ITERS, calib_bs=8)

    res, launches, shadow, others, wall, peak = _counted_fq(
        torch, fq_kernel, fq_ref, qm_kernel, lambda: quantize(model, params, calib, rc))
    views = dict(fq_kernel.VIEW_LAUNCHES)
    st = res.stats
    expect, expect_experts = _fq_expected(model, res)
    print(f"[calib_moe] {cfg.name} at full width, {MOE_LAYERS} layers ({n_moe} MoE, "
          f"{cfg.moe.n_experts} experts of d_ff {cfg.moe.d_ff_expert}), W2, "
          f"{MOE_CALIB_SEQS}x{CALIB_LEN} tokens, iters {rc.iters}, calib_bs "
          f"{rc.calib_bs}: calib_wall_s {st['calib_wall_s']:.2f}, fisher_wall_s "
          f"{st['fisher_wall_s']:.2f}, calib_iters_per_s {st['calib_iters_per_s']:.1f}, "
          f"calib_peak_bytes {st['calib_peak_bytes']} (device peak {peak} B); wall "
          f"{wall:.2f}s")
    print(f"[calib_moe] fakequant launches {launches} (expected {expect}), on stacks "
          f"of experts {views['experts']} (expected {expect_experts}); shadowed calls "
          f"{shadow['calls']}, mismatches {shadow['mismatches']}; unit retries "
          f"{st['unit_retries']}, fallbacks {st['unit_fallbacks']}, OOM halvings "
          f"{st['unit_oom_halvings']}")
    if launches != expect or views["experts"] != expect_experts or not expect_experts:
        fail(f"MoE calibration launched fakequant {launches} times ({views}), expected "
             f"{expect} ({expect_experts} on stacks of experts)")
    if any(others.values()):
        fail(f"MoE calibration launched packed-matmul kernels: {others}")
    if shadow["mismatches"] or shadow["calls"] != launches:
        fail(f"fakequant against its plain version during MoE calibration: {shadow}")
    for u in st["units"]:
        print(f"[calib_moe] unit {u['unit']}: {u['paths']} weights, rtn_recon_mse "
              f"{u['rtn_recon_mse']:.4e} final_recon_mse {u['final_recon_mse']:.4e} "
              f"loss {u['loss_first']:.4e} -> {u['loss_last']:.4e} retries "
              f"{u['retries']} fallback {u['fallback']} opt_wall_s {u['opt_wall_s']:.2f}")

    # quality gate on held-out sequences: logits MSE against FP
    walker = reconstruction.Walker(model)

    def hidden(p):  # the last block's output, before the final norm
        x, ctx = walker.stem(p, held)
        for bi in range(len(walker.blocks())):
            x = walker.apply_block(p, bi, x, ctx)
        return x

    with torch.no_grad():
        fp = model.forward(params, held)[0]
        h_fp = hidden(params)
        rtn_params = rtn_on_scales(model, params, res, held)
        mse = {"brecq": _logits_mse(torch, model, fp, held, res.params_q),
               "rtn": _logits_mse(torch, model, fp, held, rtn_params),
               "fp_mean_square": float(torch.mean(fp ** 2)),
               "hidden_brecq": float(torch.mean((hidden(res.params_q) - h_fp) ** 2)),
               "hidden_rtn": float(torch.mean((hidden(rtn_params) - h_fp) ** 2)),
               "hidden_fp_mean_square": float(torch.mean(h_fp ** 2))}
    del rtn_params, fp, h_fp
    print(f"[calib_moe] held-out logits MSE vs FP ({HELDOUT_SEQS}x{CALIB_LEN}): "
          f"BRECQ-W2 {mse['brecq']:.4e}, RTN-W2 {mse['rtn']:.4e} (ratio "
          f"{mse['brecq'] / mse['rtn']:.4f}; FP logits mean square "
          f"{mse['fp_mean_square']:.4e}); last block's output MSE vs FP: BRECQ-W2 "
          f"{mse['hidden_brecq']:.4e}, RTN-W2 {mse['hidden_rtn']:.4e} (ratio "
          f"{mse['hidden_brecq'] / mse['hidden_rtn']:.4f}; FP mean square "
          f"{mse['hidden_fp_mean_square']:.4e})")
    if not all(math.isfinite(x) for x in mse.values()) or mse["brecq"] >= mse["rtn"]:
        fail(f"MoE BRECQ-W2 logits are not closer to FP than RTN-W2's: {mse}")
    if mse["hidden_brecq"] >= mse["hidden_rtn"]:
        fail(f"MoE BRECQ-W2's last block output is not closer to FP than RTN-W2's: {mse}")

    # export, save, verified load; serve the W2 artifact through K3
    art_dir = workdir / "calib_moe_w2"
    t0 = time.perf_counter()
    export(model, res).save(str(art_dir))
    del res, params
    torch.cuda.empty_cache()
    art = QuantizedArtifact.load(str(art_dir), verify=True).to("cuda")
    serve._check_manifest(art.manifest, cfg)
    print(f"[calib_moe] artifact {art.nbytes()} B exported, saved and loaded verified "
          f"in {time.perf_counter() - t0:.1f}s")
    prompts = corpus.sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    (gen, sst), served, bodies = _counted({"qmatmul": qm_kernel}, lambda:
                                          serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag="calib_moe W2"))
    forwards = 2 + 32  # warm-up prefill and decode step, prefill, 31 decode steps
    gb = bodies["qmatmul_grouped"]
    if (served["qmatmul_grouped"] != 3 * n_moe * forwards or gb["tc"] != 3 * n_moe * 2
            or gb["gemv_tc"] != 3 * n_moe * (forwards - 2)):
        fail(f"serving the calibrated MoE artifact: qmatmul_grouped launches "
             f"{served['qmatmul_grouped']}, bodies {gb}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen,
                                       "calib_moe W2")
    print(f"[calib_moe serve] kernel launches {served}; grouped bodies {gb}; logits "
          f"kernel vs plain: max abs err {err:.3e} (tol {tol:.3e}); greedy token "
          f"agreement {agree:.4f}; prefill {sst['prefill_tok_s']:.1f} tok/s, decode "
          f"{sst['tok_s']:.1f} tok/s")
    del art
    torch.cuda.empty_cache()
    keep = ("calib_wall_s", "fisher_wall_s", "calib_iters_per_s", "calib_peak_bytes",
            "calib_peak_bytes_detail", "unit_retries", "unit_fallbacks",
            "unit_oom_halvings", "unit_cache")
    return {"launches": launches, "expected_launches": expect,
            "view_launches": views, "shadow": shadow,
            "stats": {k: st[k] for k in keep}, "device_peak_bytes": peak,
            "wall_s": wall, "logits_mse": mse,
            "units": [{k: u[k] for k in ("unit", "paths", "rtn_recon_mse",
                                         "final_recon_mse", "loss_first", "loss_last",
                                         "retries", "fallback", "opt_wall_s")}
                      for u in st["units"]],
            "serve": {"launches": served, "bodies": bodies, "logits_max_abs_err": err,
                      "token_agreement": agree, "stats": sst}}


def _time_fq_experts(torch, fq_kernel, fq_ref) -> dict:
    """K5's hardened forward at one deepseek-moe-16b expert leaf, (64,
    2048, 1408) W2 with a scale shared across experts, as its (E*K, N)
    view (the calibration's launch)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    e, (k, n) = MOE_E, next(iter(MOE_SHAPES))
    w = torch.randn((e * k, n), generator=gen, device="cuda") * 0.02
    v = torch.randn((e * k, n), generator=gen, device="cuda") * 2
    s = torch.clamp_min(w.abs().amax(0, keepdim=True) / 1, 1e-8)
    row = _time_fq(torch, fq_kernel, fq_ref, w, v, s, -2, 1)
    del w, v
    torch.cuda.empty_cache()
    return row


def phase_mixed(torch, fq_kernel, fq_ref, qm_kernel, serve, reuse: dict,
                workdir: Path) -> dict:
    """BRECQ mixed precision on the trained brecq-lm-100m at full width and
    depth: a W8 calibration beside the ``calib`` phase's W2 and W4; the
    sensitivity table (every probe's hardened forward through K5, shadowed);
    the exact solver under a bytes budget against the GA; the calibrated
    mixed artifact under that budget, served through K1/K2; then ``serve
    --budget-decode-ms --dispatch measured`` on a cost table timed from CUDA
    graph replays."""
    from repro_torch.core import ReconConfig, quantize
    from repro_torch.core.mixed_precision import GAConfig, genetic_search
    from repro_torch.core.sensitivity import measure
    from repro_torch.deploy import QuantizedArtifact, code_layout, export
    from repro_torch.deploy.budget import (CostTable, budget_artifact, install_dispatch,
                                           measure_cost_table, rtn_mixed_artifact,
                                           solve_budget, weight_shapes)
    from repro_torch.interop import flatten_paths
    from repro_torch.kernels.qmatmul import ops as qmm_ops

    model, params, calib, held = (reuse[k] for k in ("model", "params", "calib", "held"))
    cfg = model.cfg
    batch = {"tokens": torch.from_numpy(reuse["prompts"]).cuda()}
    results = {2: reuse["res"], 4: reuse["res4"]}
    shadow = {"calls": 0, "mismatches": 0}
    launches: dict = {}
    orig, fq_kernel.fakequant = _shadowed_fq(torch, fq_kernel, fq_ref, shadow)
    try:
        fq_kernel.reset_launches()
        t0 = time.perf_counter()
        results[8] = quantize(model, params, calib, ReconConfig(
            w_bits=8, iters=SENS_ITERS, calib_bs=8))
        torch.cuda.synchronize()
        t_uniform = time.perf_counter() - t0
        launches["uniform"] = fq_kernel.LAUNCHES["fakequant"]
        want = _fq_expected(model, results[8])[0]
        if launches["uniform"] != want:
            fail(f"the W8 calibration launched fakequant {launches['uniform']} "
                 f"times, expected {want}")

        fq_kernel.reset_launches()
        t0 = time.perf_counter()
        sens = measure(model, params, calib, results, n_samples=SENS_SEQS)
        torch.cuda.synchronize()
        t_sens = time.perf_counter() - t0
        launches["measure"] = fq_kernel.LAUNCHES["fakequant"]
        want = sum(p in results[b].v for (p, b) in sens.diag) + sum(
            (p1 in results[2].v) + (p2 in results[2].v) for p1, p2 in sens.offdiag)
        n_blocks = cfg.n_layers
        if (len(sens.diag) != n_blocks * 21 or len(sens.offdiag) != n_blocks * 21
                or not all(math.isfinite(x) for x in
                           (*sens.diag.values(), *sens.offdiag.values()))):
            fail(f"the sensitivity table is incomplete or not finite: {len(sens.diag)} "
                 f"diagonal, {len(sens.offdiag)} pair entries")
        if launches["measure"] != want:
            fail(f"measure launched fakequant {launches['measure']} times, expected "
                 f"{want}")
        print(f"[mixed] W8 calibration ({SENS_ITERS} iterations a block; W2 and W4 "
              f"from the calib phase) in "
              f"{t_uniform:.2f}s; sensitivity table on {SENS_SEQS} sequences: "
              f"{len(sens.diag)} diagonal + {len(sens.offdiag)} pair probes in "
              f"{t_sens:.2f}s, fakequant launches {launches['measure']}")

        # the exact solver under a bytes budget halfway between all-W2 and all-W4
        lo = rtn_mixed_artifact(params, {p: 2 for p in sens.shapes}, cfg=cfg).nbytes()
        hi = rtn_mixed_artifact(params, {p: 4 for p in sens.shapes}, cfg=cfg).nbytes()
        budget = (lo + hi) // 2
        rtn_art, sol, table = budget_artifact(params, sens, budget, kind="bytes", cfg=cfg)
        code_budget = rtn_art.manifest["budget"]["solver_budget"]
        free = solve_budget(sens, table, code_budget)
        t0 = time.perf_counter()
        _, ga = genetic_search(sens, table, code_budget, GAConfig())
        t_ga = time.perf_counter() - t0
        print(f"[mixed] bytes budget {budget} (all-W2 {lo}, all-W4 {hi}; codes "
              f"{code_budget:.0f}): exact solver with storage groups {sol.to_json()['bits_histogram']} "
              f"predicted loss {sol.predicted_loss:.6e}; without groups "
              f"{free.predicted_loss:.6e} vs GA {ga['fitness']:.6e} (GA "
              f"{GAConfig().iters} generations of {GAConfig().pop_size} in {t_ga:.2f}s)")
        if free.predicted_loss > ga["fitness"] + 1e-9 * abs(ga["fitness"]):
            fail(f"the exact solver's predicted loss {free.predicted_loss} is above the "
                 f"GA's {ga['fitness']} at the same budget")

        # the paper's route: per-layer bits -> quantize -> export -> serve
        fq_kernel.reset_launches()
        t0 = time.perf_counter()
        res_m = quantize(model, params, calib, ReconConfig(
            w_bits=2, iters=MIXED_ITERS, calib_bs=8, per_layer_bits=sol.assign))
        torch.cuda.synchronize()
        t_mixed = time.perf_counter() - t0
        launches["mixed"] = fq_kernel.LAUNCHES["fakequant"]
        if launches["mixed"] != _fq_expected(model, res_m)[0]:
            fail(f"the mixed calibration launched fakequant {launches['mixed']} times, "
                 f"expected {_fq_expected(model, res_m)[0]}")
    finally:
        fq_kernel.fakequant = orig
    if shadow["mismatches"] or shadow["calls"] != sum(launches.values()):
        fail(f"fakequant against its plain version in the mixed phase: {shadow}")
    art_m = export(model, res_m)
    shapes_of = lambda a: {k: (tuple(t.shape), t.dtype)  # noqa: E731
                           for k, t in flatten_paths(a.params).items()}
    if art_m.nbytes() > budget:
        fail(f"the calibrated mixed artifact is {art_m.nbytes()} B over its "
             f"{budget} B budget")
    if (shapes_of(art_m) != shapes_of(rtn_art)
            or art_m.manifest["bits_by_path"] != rtn_art.manifest["bits_by_path"]):
        fail("the calibrated mixed artifact's containers differ from rtn_mixed_artifact's")
    art_dir = workdir / "mixed_bytes"
    art_m.save(str(art_dir))
    art = QuantizedArtifact.load(str(art_dir)).to("cuda")
    (gen, sst), served, bodies = _counted({"qmatmul": qm_kernel}, lambda:
                                          serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag="mixed"))
    if (min(served["qgemv"], served["qmatmul"]) == 0
            or bodies["qgemv"]["gemv_tc"] != served["qgemv"]):
        fail(f"serving the mixed artifact missed a kernel or body: {served}, {bodies}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen, "mixed")
    with torch.no_grad():
        fp = model.forward(params, held)[0]
    row = {}
    for name, r in (("w2", results[2]), ("mixed", res_m), ("w4", results[4])):
        row[name] = {"bytes": export(model, r).nbytes() if r is not res_m else art_m.nbytes(),
                     "logits_mse": _logits_mse(torch, model, fp, held, r.params_q)}
    del fp
    print(f"[mixed] calibrated mixed artifact ({MIXED_ITERS} iterations a block, "
          f"{t_mixed:.2f}s): {art_m.nbytes()} B <= {budget} B, containers equal "
          f"rtn_mixed_artifact's; served: kernel launches {served}; logits kernel vs "
          f"plain max abs err {err:.3e} (tol {tol:.3e}), token agreement {agree:.4f}")

    # serve --budget-decode-ms on a table timed on K1/K2 from CUDA graph replays
    shapes = weight_shapes(params, cfg.n_layers)
    probe, ct_launches, _ = _counted({"qmatmul": qm_kernel},
                                     lambda: measure_cost_table(shapes, m=8))
    # each timing: a warm-up call and the inner calls captured in a graph
    calls = probe.meta["unique_shapes"] * (1 + probe.meta["inner"])
    if (ct_launches["qgemv"] != calls or ct_launches["qmatmul"] != calls
            or probe.backend != "cuda"):
        fail(f"the cost table did not time K1 and K2 on the card: {ct_launches}, "
             f"backend {probe.backend}")
    fastest = sum(min(probe.cost(p, b) for b in (2, 4, 8)) for p in shapes)
    slowest = sum(max(probe.cost(p, b) for b in (2, 4, 8)) for p in shapes)
    x_ms = (fastest + slowest) / 2
    env0 = os.environ.get("REPRO_QMM_DISPATCH")
    ms_dir = workdir / "mixed_ms"
    try:
        out, ms_launches, ms_bodies = _counted({"qmatmul": qm_kernel}, lambda: serve.main(
            ["--arch", "brecq_lm_100m", "--budget-decode-ms", repr(x_ms),
             "--dispatch", "measured", "--batch", "8", "--prompt-len", "64",
             "--gen-len", "32", "--no-compare-fp", "--save-artifact", str(ms_dir)],
            params=params))
        art_ms = QuantizedArtifact.load(str(ms_dir))
        info = art_ms.manifest["budget"]
        table_ms = CostTable.from_json(art_ms.manifest["cost_tables"]["cuda"])
        installed = dict(qmm_ops._DISPATCH_TABLE or {})
        parsed = {tuple(int(v) for v in key.split(",")): t
                  for key, t in table_ms.dispatch.items()}
        if info["cost"] > x_ms or info["kind"] != "decode_ms":
            fail(f"--budget-decode-ms {x_ms}: solved cost {info['cost']}")
        if qmm_ops.dispatch_mode() != "measured" or installed != parsed:
            fail("serve --dispatch measured did not install its measured table")
        # every decode-step matmul takes its (K, N, container)'s winning tier
        n_dec = 0
        for p, (k, n) in shapes.items():
            stack, rest = p.split("/", 1)
            node = art_ms.params[stack.rsplit(".", 1)[0]]
            for key in rest.split("/"):
                node = node[key]
            cb = code_layout(node["w"], k)[0]  # the stack's promoted container
            n_dec += installed.get((k, n, cb), "decode") == "decode"
        want_tiers = {"decode": n_dec, "prefill": 2 * len(shapes) - n_dec, "grouped": 0}
        if out["stats"]["qmm_tiers"] != want_tiers:
            fail(f"the measured dispatch did not route the served matmuls: tiers "
                 f"{out['stats']['qmm_tiers']}, expected {want_tiers}")
        art_ms = art_ms.to("cuda")
        ms_err, ms_tol, ms_agree = _kernel_vs_plain(torch, model, art_ms.params, batch,
                                                    out["tokens"], "mixed decode-ms")
    finally:
        install_dispatch(None)
        if env0 is None:
            os.environ.pop("REPRO_QMM_DISPATCH", None)
        else:
            os.environ["REPRO_QMM_DISPATCH"] = env0
    timed = {}
    for shape, cb, per_tier in table_ms.meta["timed"]:
        for tier, ms in per_tier.items():
            timed[f"{shape[0]}x{shape[1]}/W{cb}/{tier}"] = ms * 1e3
    smi = _smi()
    print(f"[mixed] --budget-decode-ms {x_ms:.4f} (all-fastest {fastest:.4f}, "
          f"all-slowest {slowest:.4f} ms on the probe table): solved bits "
          f"{info['bits_histogram']}, summed cost {info['cost']:.4f} ms, artifact "
          f"{art_ms.nbytes()} B; dispatch {sorted(table_ms.dispatch.items())}; served "
          f"tiers {out['stats']['qmm_tiers']}; kernel launches {ms_launches}; logits "
          f"kernel vs plain max abs err {ms_err:.3e} (tol {ms_tol:.3e})")
    print(f"[mixed] bytes / held-out logits MSE vs FP: W2 {row['w2']['bytes']} B "
          f"{row['w2']['logits_mse']:.4e}; mixed {row['mixed']['bytes']} B "
          f"{row['mixed']['logits_mse']:.4e}; W4 {row['w4']['bytes']} B "
          f"{row['w4']['logits_mse']:.4e}; cost table us per (KxN/container/tier) "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timed.items()))
          + f"; card {smi}")
    return {"fq_launches": launches, "shadow": shadow, "budget_bytes": budget,
            "solution": sol.to_json(), "free_loss": free.predicted_loss,
            "ga_fitness": ga["fitness"], "ga_wall_s": t_ga,
            "uniform_wall_s": t_uniform, "measure_wall_s": t_sens,
            "mixed_calib_wall_s": t_mixed, "quality": row,
            "serve": {"launches": served, "bodies": bodies, "logits_max_abs_err": err,
                      "token_agreement": agree, "stats": sst},
            "cost_table_launches": ct_launches, "cost_table_us": timed,
            "decode_ms": {"budget_ms": x_ms, "fastest_ms": fastest,
                          "slowest_ms": slowest, "solve": info,
                          "launches": ms_launches, "bodies": ms_bodies,
                          "tiers": out["stats"]["qmm_tiers"],
                          "logits_max_abs_err": ms_err}, "smi": smi}


# ---------------------------------------------------------------------------
# deploy: the repo's deployment tables 6-8 at full width
# ---------------------------------------------------------------------------


def _shape_counts(log: dict) -> dict:
    """``_shapes_logged``'s (kernel, M, K, N) counts as JSON keys."""
    return {f"{k}_M{m}_{kk}x{n}": v for (k, m, kk, n), v in sorted(log.items())}


def _checker(script: str, *args: str) -> str:
    """Run one of the reference's JSON guards (scripts/check_*_bench.py);
    fails the phase on a non-zero exit."""
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / script), *args],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"{script} {' '.join(args)} exited {res.returncode}: "
             f"{res.stdout.strip()} {res.stderr.strip()}")
    return res.stdout.strip()


def _t7_replay(torch, qm_kernel, c: dict) -> dict:
    """Replay the first ``T7_REPLAY_STREAMS`` streams of table 7's run
    (config ``c``: the same seed, params, RTN W4 artifact, draws and
    engine) with logits recorded: the int8 pool through the kernels against
    the plain path, and the fp16 pool through the kernels against a float32
    pool on the plain path. Each pair within ENGINE_LOGIT_TOL of max
    |logit| on the shared token history (``_agree``), over at least
    MIN_STEPS_SHARED of the steps; the kernel runs launch qmatmul at M 16."""
    from benchmarks_torch import table7_serve_mt as t7
    from repro_torch.deploy import rtn_artifact
    from repro_torch.models import get_model
    from repro_torch.serve_engine import ServeEngine

    cfg, model = get_model(c["arch"], reduced=c["reduced"])
    params = model.init(torch.Generator(device="cuda").manual_seed(c["seed"]))
    art = rtn_artifact(params, 4, cfg=cfg)
    n = T7_REPLAY_STREAMS
    draws = [d[:n] for d in t7.draw_streams(cfg.vocab, streams=c["streams"],
                                            prompt=c["prompt_len"], gen=c["gen_len"],
                                            seed=c["seed"])]
    log: dict = {}

    def run(kv_dtype, backend):
        hook = copy.copy(art.hook())  # NO_QUANT is a shared singleton
        hook.packed_backend = backend
        eng = ServeEngine(model, art.params, t7.engine_config(
            slots=c["slots"], page_size=c["page_size"], prompt=c["prompt_len"],
            gen=c["gen_len"], chunk=c["prefill_chunk"], kv_dtype=kv_dtype,
            backend=backend, record_logits=True), quant=hook)
        with _shapes_logged(qm_kernel, log):
            t7.drive(eng, *draws)
        eng.assert_no_leaks()
        return eng

    out = {"streams": n,
           "int8": _agree(run("int8", "cuda"), run("int8", "torch")),
           "fp16": _agree(run("float16", "cuda"), run("float32", "torch"))}
    out["qmatmul_M16"] = sum(v for (k, m, _, _), v in log.items()
                             if k == "qmatmul" and m == 16)
    for what, r in (("int8 pool, kernels vs plain", out["int8"]),
                    ("fp16 pool through the kernels vs float32 pool plain", out["fp16"])):
        print(f"[deploy] table 7 replay, {n} streams: {_say(what, r)}")
        limit = ENGINE_LOGIT_TOL * r["max_abs"]
        if not r["max_abs_err"] <= limit:
            fail(f"table 7 replay, {what}: logits {r['max_abs_err']:.3e} > {limit:.3e}")
        if r["steps"] < MIN_STEPS_SHARED * r["of"]:
            fail(f"table 7 replay, {what}: only {r['steps']} of {r['of']} steps on "
                 f"a shared token history")
    if out["qmatmul_M16"] == 0:
        fail(f"table 7 replay launched no qmatmul at M 16: {log}")
    return out


def phase_deploy(torch, kernels, workdir: Path) -> dict:
    """The repo's deployment tables on brecq-lm-100m at full width and depth,
    params from seed 0, through ``benchmarks_torch``: table 6's
    ``serve_bench(reduced=False)`` (FP, packed W4, packed W4 with the decode
    tier off), table 7's ``bench(reduced=False)`` (64 streams through the
    engine on int8 and fp16 pools, and the pressure pair) and table 8's
    ``main(["--full"])`` (the budget frontier). Each table's launches are
    counted from 0; the reference's guards read the three files; table 7's
    scheduler counters equal the reference's and its KV ratio is exact;
    its first streams, replayed, agree with the plain path
    (``_t7_replay``); table 6 shows the decode tier on, then off, then on
    again."""
    from benchmarks_torch import table6_deploy, table7_serve_mt, table8_budget
    from repro_torch.analysis.roofline import ideal_serve_bytes
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.models import get_config

    qm_kernel = kernels["qmatmul"]
    t_phase = time.perf_counter()
    paths = {k: workdir / f"BENCH_{k}.json" for k in ("serve", "serve_mt", "budget")}
    out: dict = {"launches": {}, "bodies": {}, "shapes": {}, "wall_s": {}}

    def table(tag, fn):
        log: dict = {}
        t0 = time.perf_counter()
        with _shapes_logged(qm_kernel, log):
            doc, launches, bodies = _counted(kernels, fn)
        out["wall_s"][tag] = time.perf_counter() - t0
        out["launches"][tag], out["bodies"][tag] = launches, bodies
        out["shapes"][tag] = _shape_counts(log)
        print(f"[deploy] {tag} in {out['wall_s'][tag]:.2f}s; kernel launches {launches}; "
              f"packed matmuls by (kernel, M, K x N) {out['shapes'][tag]}")
        return doc, launches

    # table 6: fixed-batch serving, FP vs packed W4, the decode tier on and off
    t6, l6 = table("t6", lambda: table6_deploy.serve_bench(
        reduced=False, device="cuda", out=paths["serve"]))
    if not qmm_ops.decode_tier_enabled():
        fail("the decode tier stayed off after table 6's tier-off pass")
    tiers_on = t6["packed_w4"]["qmm_tiers"]
    tiers_off = t6["packed_w4_no_decode_tier"]["qmm_tiers"]
    if not (tiers_on["decode"] > 0 and tiers_off["decode"] == 0):
        fail(f"table 6's tiers: packed {tiers_on}, tier off {tiers_off}: expected "
             f"decode > 0 with the tier on and 0 with it off")
    if not (l6["qgemv"] > 0 and l6["qmatmul"] > 0):
        fail(f"table 6 launched qgemv {l6['qgemv']} and qmatmul {l6['qmatmul']} times")
    cfg = get_config("brecq_lm_100m")
    b, p, g = (t6["config"][k] for k in ("batch", "prompt_len", "gen_len"))
    step_bound_ms = ideal_serve_bytes(cfg, ShapeSpec("t6", p + g, b, "decode"), 1,
                                      w_bits=4) / HBM_BW * 1e3
    rows6 = {k: t6[k] for k in ("fp", "packed_w4", "packed_w4_no_decode_tier")}
    step_ms = {k: 1e3 * b / r["decode_tok_s"] for k, r in rows6.items()}
    out["t6"] = {"doc": t6, "step_ms": step_ms, "step_bound_ms": step_bound_ms}
    print("[deploy] table 6 (full width, batch 8, prompt 64, gen 32): decode / prefill "
          "tok/s " + "; ".join(f"{k} {r['decode_tok_s']} / {r['prefill_tok_s']}"
                                for k, r in rows6.items())
          + f"; packed/fp decode {t6['decode_ratio_packed_vs_fp']} (prediction "
          f"0.8-1.25), tier/tier-off {t6['decode_ratio_tier_vs_legacy']} (prediction "
          f"0.8-1.25; the reference's CPU floor {T6_MIN_TIER_RATIO}, not gated); packed "
          f"decode step {step_ms['packed_w4']:.3f} ms against its bound "
          f"{step_bound_ms * 1e3:.2f} us (W4 weights + the cache once, "
          f"ideal_serve_bytes / HBM_BW)")

    # table 7: the engine under 64 staggered streams, int8 and fp16 pools, pressure
    t7, l7 = table("t7", lambda: table7_serve_mt.bench(
        reduced=False, device="cuda", out=paths["serve_mt"]))
    runs7 = {"int8": t7["int8"], "fp16": t7["fp16"],
             "pressure.none": t7["pressure"]["none"],
             "pressure.prompt": t7["pressure"]["prompt"]}
    for mode, want in T7_COUNTERS.items():
        got = tuple(runs7[mode][k] for k in T7_KEYS)
        if got != want:
            fail(f"table 7 {mode}: {dict(zip(T7_KEYS, got))} != the reference's "
                 f"{dict(zip(T7_KEYS, want))}")
    if t7["kv_bytes_ratio_fp16_over_int8"] != T7_KV_RATIO:
        fail(f"table 7's fp16/int8 KV bytes {t7['kv_bytes_ratio_fp16_over_int8']} "
             f"!= {T7_KV_RATIO}")
    m16 = sum(v for k, v in out["shapes"]["t7"].items() if k.startswith("qmatmul_M16_"))
    if not (m16 > 0 and l7["kv_decode"] > 0
            and out["bodies"]["t7"]["kv_decode_entry"]["paged"] == l7["kv_decode"]):
        fail(f"table 7 launched qmatmul at M 16 {m16} times and kv_decode "
             f"{l7['kv_decode']} times ({out['bodies']['t7']['kv_decode_entry']})")
    tok_ratio = t7["int8"]["sustained_tok_s"] / max(t7["fp16"]["sustained_tok_s"], 1e-9)
    t0 = time.perf_counter()
    replay = _t7_replay(torch, qm_kernel, t7["config"])
    out["wall_s"]["t7_replay"] = time.perf_counter() - t0
    out["t7"] = {"doc": t7, "int8_over_fp16_tok_s": tok_ratio, "replay": replay}
    print(f"[deploy] table 7 (full width, 64 streams, 16 slots): sustained tok/s int8 "
          f"{t7['int8']['sustained_tok_s']}, fp16 {t7['fp16']['sustained_tok_s']} "
          f"(int8/fp16 {tok_ratio:.3f}, prediction 0.8-1.25); pressure none "
          f"{t7['pressure']['none']['sustained_tok_s']}, prompt "
          f"{t7['pressure']['prompt']['sustained_tok_s']}; counters == the reference's; "
          f"KV bytes fp16/int8 {t7['kv_bytes_ratio_fp16_over_int8']} "
          f"({t7['int8']['bytes_per_page']} / {t7['fp16']['bytes_per_page']} B a page)")

    # table 8: the budget frontier, the exact solver against unified precision and the GA
    t8, l8 = table("t8", lambda: table8_budget.main(
        ["--full", "--device", "cuda", "--out", str(paths["budget"])]))
    if not (l8["qgemv"] > 0 and l8["qmatmul"] > 0):
        fail(f"table 8 launched qgemv {l8['qgemv']} and qmatmul {l8['qmatmul']} times")
    slowest = min(u["decode_tok_s"] for u in t8["unified"])
    tok8 = min(r["solver"]["decode_tok_s"] for r in t8["rows"]) / slowest
    ga_ok = all(r["genetic"]["fitness"] >= r["solver"]["predicted_loss"]
                for r in t8["rows"] + t8["latency_rows"])
    out["t8"] = {"doc": t8, "min_tok_ratio": tok8}
    print("[deploy] table 8 (full width): unified " + "; ".join(
        f"W{u['bits']} {u['artifact_bytes']} B loss {u['predicted_loss']:.4g} "
        f"{u['decode_tok_s']} tok/s" for u in t8["unified"]) + "; rows " + "; ".join(
        f"{r['budget_bytes']} B -> {r['solver']['artifact_bytes']} B loss "
        f"{r['solver']['predicted_loss']:.4g} (GA {r['genetic']['fitness']:.4g}) "
        f"dominates {r['dominates_unified']}" for r in t8["rows"]) + "; latency "
        + "; ".join(f"{r['budget_decode_ms']} ms -> {r['solver']['bits_histogram']} "
                    f"{r['solver']['cost_ms']} ms loss {r['solver']['predicted_loss']:.4g} "
                    f"(GA {r['genetic']['fitness']:.4g})" for r in t8["latency_rows"])
        + f"; GA never below the solver: {ga_ok}; slowest solver row / slowest "
          f"unified decode {tok8:.3f} (the reference's CPU floor {T8_MIN_TOK_RATIO}, "
          f"not gated); measured cost table {t8['measured_cost_meta'].get('timed')}")

    out["checkers"] = [
        _checker("check_serve_bench.py", "--serve", str(paths["serve"]), "--mt",
                 str(paths["serve_mt"]), "--require", "both", "--min-tier-ratio", "0"),
        _checker("check_budget_bench.py", "--budget", str(paths["budget"]), "--require",
                 "--min-tok-ratio", "0")]
    for line in out["checkers"]:
        print(f"[deploy] {line}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[deploy] phase {out['phase_wall_s']:.2f}s (prediction 60-150); card {_smi()}")
    return out


# ---------------------------------------------------------------------------
# the attention families: whisper-small, llama-3.2-vision-90b, gemma3-12b and
# h2o-danube3-4b at full width
# ---------------------------------------------------------------------------


def _open_gates(tree):
    """Every cross-attention gate at XGATE (JAX's init of 0 would leave the
    logits blind to the frames and the patches); returns ``tree``."""
    for k, v in tree.items():
        if k == "xgate":
            v.fill_(XGATE)
        elif isinstance(v, dict):
            _open_gates(v)
    return tree


@contextlib.contextmanager
def _shapes_logged(qm_kernel, log: dict):
    """Count the packed matmuls' launches by (kernel, M, K, N) while serving:
    ``qmm`` looks the kernels up on their module on every call."""
    orig = {n: getattr(qm_kernel, n) for n in ("qgemv", "qmatmul")}

    def wrap(name):
        def fn(x, wp, s, *, bits):
            key = (name, x.shape[0], x.shape[-1], wp.shape[-1])
            log[key] = log.get(key, 0) + 1
            return orig[name](x, wp, s, bits=bits)
        return fn

    for n in orig:
        setattr(qm_kernel, n, wrap(n))
    try:
        yield log
    finally:
        for n, f in orig.items():
            setattr(qm_kernel, n, f)


def _time_paged(torch, F, kv_kernel, kv_ref, B, H, K, hd, ps, mp, *, idle, seed=1,
                window=None) -> dict:
    """K4's paged entry at (B, H, K, hd) over ``mp`` pages of ``ps`` a
    stream: kernel, the gather + casts + dense kernel it replaces, the
    dense kernel on the gathered view, the plain version, the library
    yardstick and this data's bound."""
    from repro_torch.kernels.spec import kv_decode_body, plan_kv_decode

    q, pool, bt, cur = paged_inputs(torch, B, H, K, hd, ps, mp, seed=seed, idle=idle)
    per_set = sum(t.numel() * t.element_size() for t in pool.values())
    sets = [(q, *(pool[k].clone() for k in ("k_pages", "v_pages", "k_scale", "v_scale")),
             bt, cur) for _ in range(max(2, math.ceil(L2_FLUSH_BYTES / per_set)))]
    t_paged = graph_time_ms(torch, lambda *a: kv_kernel.kv_decode_paged(
        *a, page_size=ps, window=window), sets)
    t_gd = graph_time_ms(torch, lambda *a: kv_kernel.kv_decode(
        *_gathered(a, ps), window=window), sets)
    t_plain = graph_time_ms(torch, lambda *a: kv_ref.kv_decode_ref(
        *_gathered(a, ps), window), sets)
    t_dense = graph_time_ms(torch, lambda *a: kv_kernel.kv_decode(*a, window=window),
                            [_gathered(a, ps) for a in sets])
    t_lib, lib_err = sdpa_time(torch, F, kv_ref, _gathered(sets[0], ps))
    del sets
    b_ms, b_by = kv_paged_bound(q, bt, cur, K, ps)
    plan = plan_kv_decode(B, K, mp * ps, hd, H // K)
    print(f"[time] kv_decode paged  B={B} H={H} K={K} hd={hd:3d} S={mp * ps:4d} "
          f"(pages of {ps}): kernel {t_paged*1e3:9.2f} us  gather + dense kernel "
          f"{t_gd*1e3:9.2f} us  dense kernel on the gathered view {t_dense*1e3:9.2f} us  "
          f"plain {t_plain*1e3:9.2f} us  library {t_lib*1e3:9.2f} us (err "
          f"{lib_err:.1e})  bound {b_ms*1e3:7.2f} us ({b_by})  {kv_decode_body(hd)}, "
          f"{plan.warps} warps, split {plan.split}")
    return {"B": B, "H": H, "K": K, "hd": hd, "S": mp * ps, "page_size": ps,
            "body": kv_decode_body(hd), "warps": plan.warps, "split": plan.split,
            "ms": t_paged, "gather_dense_ms": t_gd, "dense_ms": t_dense,
            "plain_ms": t_plain, "library_ms": t_lib, "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_family_kernels(torch, kernel, ref, pack, kv_kernel, kv_ref) -> dict:
    """K1, K2 and K4 against their plain versions at the shapes no earlier
    path ran, and timed there: K1 on llama-3.2-vision-90b's MLP (8,192 x
    28,672 and back, W4 and W2: weights far larger than L2), K2 over
    whisper-small's encoder (8 x 1,500 frames: M 12,000 into its MLP) and
    the VLM's cross-attention K/V (8 x 1,024 patches, K 8,192, N 1,024), and
    K4's paged entry at h2o-danube3-4b's (hd 120, G 4, the 8-byte body) and
    gemma3-12b's (hd 256, G 2) decode reads over the dense engines' pools."""
    import torch.nn.functional as F

    from repro_torch.kernels.kvattn import ops as kv_ops
    from repro_torch.kernels.spec import kv_decode_body

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"qgemv": 0.0, "qmatmul": 0.0, "kv_decode": 0.0}
    rows = {}
    fns = {"qgemv": (kernel.qgemv, ref.qgemv_ref),
           "qmatmul": (kernel.qmatmul, ref.qmatmul_ref)}
    for name, m, k, n, bits, timed in FAMILY_QMM:
        fn, plain = fns[name]
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        wp, s = pack.rtn_pack_leaf(w, bits, None)
        del w
        x = torch.randn((m, k), generator=gen, device=dev)
        out, want = fn(x, wp, s, bits=bits), plain(x, wp, s, bits)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        errs[name] = max(errs[name], err)
        if not math.isfinite(err) or err > tolerance(want):
            fail(f"{name} W{bits} M={m} K={k} N={n}: max abs err {err:.3e} > tol "
                 f"{tolerance(want):.3e}")
        del out, want
        if timed:
            rows[timed] = _time_case(torch, name, fn, plain, ref, x, wp, s, bits, None,
                                     m, k, n, err, rel)
        del x, wp, s
        torch.cuda.empty_cache()
    for label, (B, H, K, hd, ps, mp, window) in FAMILY_KV.items():
        for win in (window, FAMILY_KV_MASKING_WINDOW):
            q, pool, bt, cur = paged_inputs(torch, B, H, K, hd, ps, mp, idle=1)
            before = dict(kv_kernel.BODY_LAUNCHES["kv_decode"])
            got = kv_ops.attend_int8_paged(q, pool, bt, cur, ps, window=win,
                                           backend="cuda")
            want = kv_ops.attend_int8_paged(q, pool, bt, cur, ps, window=win,
                                            backend="torch")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["kv_decode"] = max(errs["kv_decode"], err)
            body = kv_decode_body(hd)
            if kv_kernel.BODY_LAUNCHES["kv_decode"][body] != before[body] + 1:
                fail(f"kv_decode paged at hd {hd} did not take its body {body}")
            if not math.isfinite(err) or err > tolerance(want):
                fail(f"kv_decode paged {label} window {win}: max abs err {err:.3e} > "
                     f"tol {tolerance(want):.3e}")
        rows[label] = _time_paged(torch, F, kv_kernel, kv_ref, B, H, K, hd, ps, mp,
                                  idle=1, window=window)
    print(f"[family] kernel-vs-plain at the families' shapes within 1e-4*max|ref|+1e-5: "
          f"max abs err {errs}")
    return {"errs": errs, "rows": rows}


def _with_frames(torch, gen, batch: dict, d: int) -> dict:
    """``batch`` on the card with WHISPER_FRAMES frames of width ``d`` a
    sequence, normals from ``gen`` (the stub frontend's embeddings)."""
    out = {k: t.cuda() for k, t in batch.items()}
    b = out["tokens"].shape[0]
    out["frames"] = torch.randn((b, WHISPER_FRAMES, d), generator=gen, device="cuda")
    return out


def phase_whisper(torch, fq_kernel, fq_ref, qm_kernel, serve, workdir: Path) -> dict:
    """whisper-small at full width, depth cut to WHISPER_LAYERS encoder +
    WHISPER_LAYERS decoder layers, every cross-attention gate at XGATE: BRECQ W4 calibration
    through ``repro_torch.core.quantize`` (encoder units, the boundary,
    decoder units; every K5 call shadowed), BRECQ against RTN on held-out
    logits and on the last encoder block's output, export, verified load,
    and a fixed batch served from the packed artifact through K2 (the
    encoder at M 12,000) and K1 (decode), replayed by the plain path; the
    logits move when the frames are redrawn."""
    from repro_torch.core import ReconConfig, quantize, reconstruction, rtn_on_scales
    from repro_torch.data import Corpus, CorpusConfig, make_batches
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.models import build_model, get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("whisper_small"), n_layers=WHISPER_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _open_gates(model.init(gen))
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    calib = [_with_frames(torch, gen, b, cfg.d_model) for b in
             make_batches(corpus, WHISPER_SEQS // 8, 8, CALIB_LEN, seed=1)]
    held = _with_frames(torch, gen, make_batches(corpus, 1, HELDOUT_SEQS, CALIB_LEN,
                                                 seed=2)[0], cfg.d_model)
    rc = ReconConfig(w_bits=4, iters=WHISPER_ITERS, calib_bs=8)
    res, launches, shadow, others, wall, peak = _counted_fq(
        torch, fq_kernel, fq_ref, qm_kernel, lambda: quantize(model, params, calib, rc))
    st = res.stats
    walker = reconstruction.Walker(model)
    expect, _ = _fq_expected(model, res)
    units = [u["unit"] for u in st["units"]]
    print(f"[whisper] {cfg.name} full width, depth cut to ({cfg.n_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, vocab {cfg.vocab}), "
          f"W4, {WHISPER_SEQS}x{CALIB_LEN} tokens over {WHISPER_FRAMES} frames, iters "
          f"{rc.iters}, calib_bs {rc.calib_bs}: calib_wall_s {st['calib_wall_s']:.2f}, "
          f"fisher_wall_s {st['fisher_wall_s']:.2f}, calib_iters_per_s "
          f"{st['calib_iters_per_s']:.1f}, calib_peak_bytes {st['calib_peak_bytes']} "
          f"(device peak {peak} B); wall {wall:.2f}s")
    print(f"[whisper] {len(units)} units, the boundary after {walker.block_path(walker.enc_n - 1)}"
          f"; fakequant launches {launches} (expected {expect}); shadowed calls "
          f"{shadow['calls']}, mismatches {shadow['mismatches']}; unit retries "
          f"{st['unit_retries']}, fallbacks {st['unit_fallbacks']}, OOM halvings "
          f"{st['unit_oom_halvings']}")
    if units != [[i] for i in range(2 * cfg.n_layers)] or walker.enc_n != cfg.n_layers:
        fail(f"whisper's units are not its {cfg.n_layers} encoder then {cfg.n_layers} "
             f"decoder blocks: {units}")
    if launches != expect:
        fail(f"whisper calibration launched fakequant {launches} times, expected {expect}")
    if any(others.values()):
        fail(f"whisper calibration launched packed-matmul kernels: {others}")
    if shadow["mismatches"] or shadow["calls"] != launches:
        fail(f"fakequant against its plain version during whisper calibration: {shadow}")
    for u in st["units"]:
        print(f"[whisper] unit {u['unit']} {walker.block_path(u['unit'][0])}: "
              f"{u['paths']} weights, rtn_recon_mse {u['rtn_recon_mse']:.4e} "
              f"final_recon_mse {u['final_recon_mse']:.4e} retries {u['retries']} "
              f"fallback {u['fallback']} opt_wall_s {u['opt_wall_s']:.2f}")

    # quality gates on held-out sequences: logits and the last encoder
    # block's output (before the encoder's norm) against FP
    def encoded(p):
        x, ctx = walker.stem(p, held)
        for bi in range(walker.enc_n):
            x = walker.apply_block(p, bi, x, ctx)
        return x

    with torch.no_grad():
        fp = model.forward(params, held)[0]
        e_fp = encoded(params)
        rtn_params = rtn_on_scales(model, params, res, held)
        mse = {"brecq": _logits_mse(torch, model, fp, held, res.params_q),
               "rtn": _logits_mse(torch, model, fp, held, rtn_params),
               "fp_mean_square": float(torch.mean(fp ** 2)),
               "encoder_brecq": float(torch.mean((encoded(res.params_q) - e_fp) ** 2)),
               "encoder_rtn": float(torch.mean((encoded(rtn_params) - e_fp) ** 2)),
               "encoder_fp_mean_square": float(torch.mean(e_fp ** 2))}
    del rtn_params, fp, e_fp
    print(f"[whisper] held-out logits MSE vs FP ({HELDOUT_SEQS}x{CALIB_LEN} over "
          f"{WHISPER_FRAMES} frames): BRECQ-W4 {mse['brecq']:.4e}, RTN-W4 "
          f"{mse['rtn']:.4e} (ratio {mse['brecq'] / mse['rtn']:.4f}; FP logits mean "
          f"square {mse['fp_mean_square']:.4e}); last encoder block's output MSE vs FP: "
          f"BRECQ-W4 {mse['encoder_brecq']:.4e}, RTN-W4 {mse['encoder_rtn']:.4e} (ratio "
          f"{mse['encoder_brecq'] / mse['encoder_rtn']:.4f}; FP mean square "
          f"{mse['encoder_fp_mean_square']:.4e})")
    if not all(math.isfinite(x) for x in mse.values()) or mse["brecq"] >= mse["rtn"]:
        fail(f"whisper BRECQ-W4 logits are not closer to FP than RTN-W4's: {mse}")
    if mse["encoder_brecq"] >= mse["encoder_rtn"]:
        fail(f"whisper BRECQ-W4's last encoder block is not closer to FP than RTN-W4's: "
             f"{mse}")

    # export, save, verified load: the block weights are params_q bit for bit
    t0 = time.perf_counter()
    art, n_blocks = _export_verified(torch, model, res, serve, workdir / "whisper_w4",
                                     "whisper")
    for key in ("enc_pos", "enc_norm"):
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(art.params[key]),
                                                     tree_leaves(res.params_q[key])))
        if not same:
            fail(f"the whisper artifact's {key} is not the model's")
    print(f"[whisper] artifact {art.nbytes()} B ({art.manifest['family']}) exported, "
          f"saved and loaded verified in {time.perf_counter() - t0:.1f}s; the "
          f"{n_blocks} block weights equal params_q bit for bit")
    del res, params
    torch.cuda.empty_cache()

    # the fixed batch from the packed artifact: K2 over the encoder and
    # the prompt, K1 on every decode step
    prompts = corpus.sample(8, 64, seed=7)
    batch = _with_frames(torch, gen, {"tokens": torch.from_numpy(prompts)}, cfg.d_model)
    qmm_ops.reset_tier_counts()
    (gen_toks, sst), served, bodies = _counted({"qmatmul": qm_kernel}, lambda:
                                               serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag="whisper W4"))
    if (served["qgemv"] == 0 or served["qmatmul"] == 0
            or bodies["qgemv"]["gemv_tc"] != served["qgemv"]
            or bodies["qmatmul"]["tc"] != served["qmatmul"]):
        fail(f"serving whisper missed a kernel or left the tensor-core bodies: "
             f"{served}, {bodies}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen_toks,
                                       "whisper W4")
    hook = art.hook()
    with torch.inference_mode():
        qmm_ops.reset_tier_counts()
        qm_kernel.reset_launches()
        memory = model.encode(art.params, batch["frames"], hook)
        enc_k = (dict(qm_kernel.LAUNCHES), dict(qmm_ops.TIER_COUNTS))
        cache = model.init_cache(8, 65, torch.float32, "cuda")
        logits, cache = model.prefill(art.params, {"tokens": batch["tokens"],
                                                   "memory": memory}, cache, hook)
        qmm_ops.reset_tier_counts()
        qm_kernel.reset_launches()
        model.decode_step(art.params, logits.argmax(-1)[:, None].to(torch.int32), cache,
                          torch.full((8,), 64, dtype=torch.int32, device="cuda"), hook)
        dec_k = (dict(qm_kernel.LAUNCHES), dict(qmm_ops.TIER_COUNTS))
        other = dict(batch, frames=torch.randn(batch["frames"].shape, generator=gen,
                                               device="cuda"))
        cache = model.init_cache(8, 65, torch.float32, "cuda")
        moved = float((model.prefill(art.params, other, cache, hook)[0] - logits)
                      .abs().max())
    n_enc, n_dec = 6 * cfg.n_layers, 8 * cfg.n_layers + 1
    print(f"[whisper serve] kernel launches {served}, bodies {bodies['qmatmul']} / "
          f"{bodies['qgemv']}; the encoder alone (M {8 * WHISPER_FRAMES}): launches "
          f"{enc_k[0]}, tiers {enc_k[1]}; one decode step: launches {dec_k[0]}, tiers "
          f"{dec_k[1]}; logits kernel vs plain: max abs err {err:.3e} (tol {tol:.3e}); "
          f"greedy token agreement {agree:.4f}; redrawn frames move the logits by "
          f"{moved:.3e} (over {MEMORY_MOVES['whisper'] * tol:.3e}); prefill "
          f"{sst['prefill_tok_s']:.1f} "
          f"tok/s, decode {sst['tok_s']:.1f} tok/s")
    if (enc_k[0]["qmatmul"] != n_enc or enc_k[1]["prefill"] != n_enc
            or enc_k[0]["qgemv"] or enc_k[1]["decode"]):
        fail(f"whisper's encoder did not run its {n_enc} matmuls on K2: {enc_k}")
    if (dec_k[0]["qgemv"] != n_dec or dec_k[1]["decode"] != n_dec
            or dec_k[0]["qmatmul"] or dec_k[1]["prefill"]):
        fail(f"whisper's decode step did not run its {n_dec} matmuls on K1: {dec_k}")
    if not moved > MEMORY_MOVES["whisper"] * tol:
        fail(f"whisper's logits hardly move when the frames are redrawn: {moved:.3e}")
    del art, memory, cache
    torch.cuda.empty_cache()
    keep = ("calib_wall_s", "fisher_wall_s", "calib_iters_per_s", "calib_peak_bytes",
            "calib_peak_bytes_detail", "unit_retries", "unit_fallbacks",
            "unit_oom_halvings", "unit_cache")
    return {"launches": launches, "expected_launches": expect, "shadow": shadow,
            "stats": {k: st[k] for k in keep}, "device_peak_bytes": peak,
            "wall_s": wall, "logits_mse": mse,
            "units": [{k: u[k] for k in ("unit", "paths", "rtn_recon_mse",
                                         "final_recon_mse", "retries", "fallback",
                                         "opt_wall_s")} for u in st["units"]],
            "serve": {"launches": served, "bodies": bodies, "logits_max_abs_err": err,
                      "logits_tol": tol, "token_agreement": agree, "stats": sst,
                      "encoder_launches": enc_k, "decode_step_launches": dec_k,
                      "frames_redrawn_max_abs": moved},
            "phase_wall_s": time.perf_counter() - t_phase}


def phase_vlm(torch, qm_kernel, serve, workdir: Path) -> dict:
    """llama-3.2-vision-90b at full width, cut to one group of VLM_LAYERS
    (4 self-attention layers and the gated cross-attention layer), every
    gate at XGATE: RTN W4 packed on the card, a fixed batch of 8 x 64 prompt
    + 32 generated tokens with 1,024 patches an image through K1/K2 (the
    MLP's 8,192 x 28,672 on K1 at every decode step), replayed by the plain
    path; the logits move when the patches are redrawn."""
    from repro_torch.data import Corpus, CorpusConfig
    from repro_torch.deploy import rtn_artifact, tree_bytes
    from repro_torch.models import build_model, get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama32_vision_90b"), n_layers=VLM_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = _open_gates(model.init(gen))
    fp_bytes = tree_bytes(params)
    art = rtn_artifact(params, 4, None, cfg=cfg)
    del params
    torch.cuda.empty_cache()
    art_bytes = art.nbytes()
    print(f"[vlm] {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {VLM_LAYERS} "
          f"layers ({VLM_LAYERS - 1} self-attention + 1 cross-attention): W4 artifact "
          f"{art_bytes} B vs fp {fp_bytes} B, made on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    prompts = Corpus(CorpusConfig(vocab=cfg.vocab)).sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda(),
             "patches": torch.randn((8, cfg.n_patches, cfg.d_model), generator=gen,
                                    device="cuda")}
    shapes: dict = {}
    with _shapes_logged(qm_kernel, shapes):
        (gen_toks, sst), served, bodies = _counted({"qmatmul": qm_kernel}, lambda:
                                                   serve.run_prefill_decode(
            model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
            hook=art.hook(), tag="vlm W4"))
    mlp = shapes.get(("qgemv", 8, cfg.d_model, cfg.d_ff), 0)
    xkv = shapes.get(("qmatmul", 8 * cfg.n_patches, cfg.d_model, cfg.n_kv_heads * cfg.hd), 0)
    if (served["qgemv"] == 0 or served["qmatmul"] == 0
            or bodies["qgemv"]["gemv_tc"] != served["qgemv"]
            or bodies["qmatmul"]["tc"] != served["qmatmul"]):
        fail(f"serving the VLM missed a kernel or left the tensor-core bodies: "
             f"{served}, {bodies}")
    # w_gate and w_up of every layer at the warm-up and the 31 timed decode steps
    if mlp != 2 * VLM_LAYERS * 32:
        fail(f"K1 ran {mlp} times on {cfg.d_model} x {cfg.d_ff}, not "
             f"{2 * VLM_LAYERS * 32}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen_toks, "vlm W4")
    with torch.inference_mode():
        logits = [model.prefill(art.params, b, model.init_cache(
            8, 65, torch.float32, "cuda"), art.hook())[0]
            for b in (batch, dict(batch, patches=torch.randn(
                batch["patches"].shape, generator=gen, device="cuda")))]
    moved = float((logits[0] - logits[1]).abs().max())
    print(f"[vlm serve] kernel launches {served}, bodies {bodies['qmatmul']} / "
          f"{bodies['qgemv']}; K1 on {cfg.d_model}x{cfg.d_ff} {mlp} times, K2 on the "
          f"cross-attention K/V over {8 * cfg.n_patches} patch rows {xkv} times; logits "
          f"kernel vs plain: max abs err {err:.3e} (tol {tol:.3e}); greedy token "
          f"agreement {agree:.4f}; redrawn patches move the logits by {moved:.3e} "
          f"(over {MEMORY_MOVES['vlm'] * tol:.3e}); prefill {sst['prefill_tok_s']:.1f} "
          f"tok/s, decode "
          f"{sst['tok_s']:.1f} tok/s; device peak {torch.cuda.max_memory_allocated()} B")
    if not moved > MEMORY_MOVES["vlm"] * tol:
        fail(f"the VLM's logits hardly move when the patches are redrawn: {moved:.3e}")
    del art, batch, logits
    torch.cuda.empty_cache()
    return {"launches": served, "bodies": bodies, "stats": sst,
            "shape_launches": {f"{n} M={m} {k}x{nn}": c for (n, m, k, nn), c in shapes.items()},
            "logits_max_abs_err": err, "logits_tol": tol, "token_agreement": agree,
            "patches_redrawn_max_abs": moved, "artifact_bytes": art_bytes,
            "fp_bytes": fp_bytes, "phase_wall_s": time.perf_counter() - t_phase}


def _family_streams(cfg, n: int, seed: int) -> list:
    """``n`` engine streams: arrivals over 4n ticks, prompts of
    DENSE_PROMPTS tokens from the corpus, 16-32 generated."""
    import numpy as np

    from repro_torch.data import Corpus, CorpusConfig

    rng = np.random.default_rng(seed)
    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    arrivals = sorted(int(a) for a in rng.integers(0, 4 * n, n))
    plens = rng.integers(DENSE_PROMPTS[0], DENSE_PROMPTS[1] + 1, n)
    gens = rng.integers(16, 33, n)
    return [(arrivals[i], corpus.sample(1, int(plens[i]), seed=seed + i)[0], int(gens[i]))
            for i in range(n)]


def _dense_engine(torch, serve, kernels, arch: str, n_layers: int, body: str) -> dict:
    """One dense config at full width through the continuous-batching
    engine over an int8 page pool: RTN W4 on the card, 8 slots, 16 staggered
    streams; every kernel launched, every kv_decode launch on the paged
    entry and ``body``, shadowed by its plain version; kernel vs plain logits
    within ENGINE_LOGIT_TOL of max |logit|; staggered == sequential."""
    import numpy as np

    from repro_torch.deploy import rtn_artifact, tree_bytes
    from repro_torch.models import build_model, get_config

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    params = engine_params(torch, model)
    fp_bytes = tree_bytes(params)
    art = rtn_artifact(params, 4, None, cfg=cfg)
    del params
    torch.cuda.empty_cache()
    args = serve.parse_args(["--arch", arch, "--engine", "--quant", "4", "--batch", "8",
                             "--prompt-len", str(DENSE_PROMPTS[1]), "--gen-len", "32",
                             "--kv-dtype", "int8", "--seed", "0"])
    streams = _family_streams(cfg, DENSE_ENGINE_STREAMS, 0)
    shadow = {"calls": 0, "max_abs_err": 0.0, "worst_err_over_tol": 0.0}
    with _attend_wrapped(_shadowed(shadow)):
        kern, launches, bodies = _counted(kernels, lambda: _engine(
            serve, model, art, args, streams, "cuda"))
    m = kern.metrics()
    entries = bodies["kv_decode_entry"]
    distinct = sorted(len(set(t)) for t in _tokens(kern).values())
    print(f"[dense {arch}] {cfg.n_layers} layers at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.hd}, vocab {cfg.vocab}): W4 "
          f"{art.nbytes()} B vs fp {fp_bytes} B; engine kernel launches {launches}, "
          f"kv_decode bodies {bodies['kv_decode']}, entries {entries}, splits "
          f"{bodies['kv_decode_split']}; {m['tokens_generated']} tokens in "
          f"{m['wall_s']:.2f}s ({m['sustained_tok_s']:.1f} tok/s sustained, "
          f"{m['ticks']} ticks), occupancy {m['mean_slot_occupancy']:.3f}; kv_decode vs "
          f"plain on the engine's inputs: {shadow['calls']} calls, worst err/tol "
          f"{shadow['worst_err_over_tol']:.3f}; distinct tokens per stream {distinct}")
    if min(launches[k] for k in ("qgemv", "qmatmul", "kv_decode")) == 0:
        fail(f"the {arch} engine did not launch every kernel: {launches}")
    if (bodies["qgemv"]["gemv_tc"] != launches["qgemv"]
            or bodies["qmatmul"]["tc"] != launches["qmatmul"]):
        fail(f"the {arch} engine left the tensor-core bodies: {bodies}")
    if (bodies["kv_decode"][body] != launches["kv_decode"]
            or entries["paged"] != launches["kv_decode"]):
        fail(f"the {arch} engine's decode reads did not all take the paged entry's "
             f"{body} body: {bodies['kv_decode']}, {entries}")
    if {r.state for r in kern.requests.values()} != {"done"}:
        fail(f"{arch} engine requests did not all finish")
    if shadow["calls"] == 0 or shadow["worst_err_over_tol"] > 1.0:
        fail(f"{arch} kv_decode vs its plain version on the engine's pool: {shadow}")
    if np.median(distinct) < MIN_DISTINCT_TOKENS:
        fail(f"the {arch} streams' greedy tokens hardly vary ({distinct})")
    vs_plain = _agree(kern, _engine(serve, model, art, args, streams, "torch"))
    tol = ENGINE_LOGIT_TOL * vs_plain["max_abs"]
    print(f"[dense {arch}] {_say('kernel vs plain path, int8 pool', vs_plain)} (limit "
          f"{tol:.3e})")
    if vs_plain["max_abs_err"] > tol:
        fail(f"{arch} engine logits, kernel vs plain: {vs_plain['max_abs_err']:.3e} > "
             f"{tol:.3e}")
    if vs_plain["steps"] < MIN_STEPS_SHARED * vs_plain["of"]:
        fail(f"{arch} engine: only {vs_plain['steps']} of {vs_plain['of']} steps on a "
             f"shared token history")
    four = streams[:4]
    stag = _engine(serve, model, art, args, four, "cuda")
    seq = _engine(serve, model, art, args, four, "cuda", sequential=True)
    ls, lq = _logits(stag), _logits(seq)
    if not (all(np.array_equal(ls[u], lq[u]) for u in ls)
            and _tokens(stag) == _tokens(seq)):
        fail(f"{arch} engine: staggered and sequential serving of 4 streams differ")
    print(f"[dense {arch}] staggered == sequential for 4 streams: tokens and logits "
          f"bit-identical ({stag.metrics()['ticks']} vs {seq.metrics()['ticks']} ticks)")
    del art, kern, stag, seq
    torch.cuda.empty_cache()
    return {"launches": launches, "bodies": bodies, "metrics": m,
            "kv_decode_on_engine_inputs": shadow, "kernel_vs_plain_int8": vs_plain,
            "logits_limit": tol, "distinct_tokens_per_stream": distinct,
            "fp_bytes": fp_bytes, "phase_wall_s": time.perf_counter() - t_phase}


def phase_dense_cfgs(torch, serve, kernels) -> dict:
    """h2o-danube3-4b at full width (depth cut to DANUBE_LAYERS), gemma3-12b at full width
    (one local:global group) and internlm2-20b at full width (depth cut to
    INTERNLM_LAYERS) through the engine: K4's paged entry on its 8-byte body
    at hd 120 and its 16-byte body at hd 256 and at hd 128 with G 6."""
    out = {}
    for arch, n_layers, body in (("h2o_danube3_4b", DANUBE_LAYERS, "v8"),
                                 ("gemma3_12b", GEMMA_LAYERS, "v16"),
                                 ("internlm2_20b", INTERNLM_LAYERS, "v16")):
        t0 = time.perf_counter()
        out[arch] = _dense_engine(torch, serve, kernels, arch, n_layers, body)
        out[arch]["phase_s"] = time.perf_counter() - t0
        print(f"[dense] {arch}: {out[arch]['phase_s']:.1f}s")
    out["h2o_danube3_4b"]["reduced"] = {"n_layers": [24, DANUBE_LAYERS],
                                        "why": "the run's wall"}
    out["gemma3_12b"]["reduced"] = {"n_layers": [48, GEMMA_LAYERS]}
    out["internlm2_20b"]["reduced"] = {
        "n_layers": [48, INTERNLM_LAYERS],
        "why": "48 layers are ≈ 80 GB as f32; the width stays"}
    return out


def phase_recurrent_kernels(torch, kernel, ref, pack, fq_kernel, fq_ref) -> dict:
    """K1, K2 and K5 against their plain versions at the recurrent families'
    new shapes (RECURRENT_SHAPES) and whisper-small's head (HEAD_SHAPES), and
    timed there: K1 at M 8 and K2 at M
    512 (the fixed batch's prefill), W4 and W2, within 1e-4*max|ref|+1e-5;
    K5 hard bit for bit and soft within 1e-6*max|ref|, W4 and W2, (1, N)
    scales. Times (K1 and K2 at W4 with their library yardstick, K5 hard at
    W2): kernel, plain version and this call's bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"qgemv": 0.0, "qmatmul": 0.0, "fakequant": 0.0}
    rows = {"qgemv": [], "qmatmul": [], "fakequant": []}
    fns = {"qgemv": (kernel.qgemv, ref.qgemv_ref, 8, "gemv_tc"),
           "qmatmul": (kernel.qmatmul, ref.qmatmul_ref, 512, "tc")}
    for label, k, n in RECURRENT_SHAPES + HEAD_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        for bits in (4, 2):
            wp, s = pack.rtn_pack_leaf(w, bits, None)
            for name, (fn, plain, m, body) in fns.items():
                x = torch.randn((m, k), generator=gen, device=dev)
                before = kernel.BODY_LAUNCHES[name][body]
                out, want = fn(x, wp, s, bits=bits), plain(x, wp, s, bits)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                errs[name] = max(errs[name], err)
                if kernel.BODY_LAUNCHES[name][body] != before + 1:
                    fail(f"{name} at {label} ({k} x {n}) did not take its body {body}")
                if not math.isfinite(err) or err > tolerance(want):
                    fail(f"{name} W{bits} M={m} {label} K={k} N={n}: max abs err "
                         f"{err:.3e} > tol {tolerance(want):.3e}")
                if bits == 4:
                    row = _time_case(torch, name, fn, plain, ref, x, wp, s, bits, None,
                                     m, k, n, err, err / max(float(want.abs().max()), 1e-30))
                    rows[name].append({"label": label, **row})
                del out, want, x
            qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
            v = torch.randn((k, n), generator=gen, device=dev) * 2
            s_row = torch.clamp_min(w.abs().amax(0, keepdim=True) / qmax, 1e-8)
            for hard in (True, False):
                out = fq_kernel.fakequant(w, v, s_row, qmin=qmin, qmax=qmax, hard=hard)
                want = fq_ref.fakequant_ref(w, v, s_row, qmin, qmax, hard)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if hard and not torch.equal(out, want):
                    fail(f"fakequant W{bits} hard {label} K={k} N={n}: not bit-identical "
                         f"to the plain version (max abs err {err:.3e})")
                if not math.isfinite(err) or err > 1e-6 * float(want.abs().max()):
                    fail(f"fakequant W{bits} {label} K={k} N={n}: max abs err {err:.3e}")
                errs["fakequant"] = max(errs["fakequant"], err)
            if bits == 2:  # as the brecq block's K5 rows: hard, W2, (1, N) scales
                rows["fakequant"].append({"label": label, **_time_fq(
                    torch, fq_kernel, fq_ref, w, v, s_row, qmin, qmax)})
            del v, out, want
        del w
        torch.cuda.empty_cache()
    print(f"[recurrent] kernel-vs-plain at the recurrent families' {len(RECURRENT_SHAPES)} "
          f"new shapes and whisper's head, W4 and W2 (K1/K2 within 1e-4*max|ref|+1e-5, K5 hard bit for "
          f"bit): max abs err {errs}")
    return {"errs": errs, "rows": rows}


@contextlib.contextmanager
def _timed_calls(torch, targets: dict):
    """CUDA events around every outermost call of each ``targets[label] =
    (module, name)``; yields {label: [(start, end), ...]}. The functions are
    looked up on their modules at every call, so the wrappers see them
    all; a call inside a timed call (the scan's own recursion) is not
    timed again."""
    events = {label: [] for label in targets}
    orig = {label: getattr(mod, name) for label, (mod, name) in targets.items()}
    depth = [0]

    def wrap(label, fn):
        def timed(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            try:
                return fn(*a, **kw)
            finally:
                ev[1].record()
                depth[0] -= 1
                events[label].append(ev)
        return timed

    for label, (mod, name) in targets.items():
        setattr(mod, name, wrap(label, orig[label]))
    try:
        yield events
    finally:
        for label, (mod, name) in targets.items():
            setattr(mod, name, orig[label])


def _prefill_shares(torch, model, params, hook, batch) -> dict:
    """One prefill of ``batch`` between CUDA events, with events around every
    associative scan (the SSM's selective scan, the sLSTM's three) and every
    mLSTM chunk: device-stream ms of each and their share of the prefill
    (idle gaps between the host's launches included in all of them)."""
    from repro_torch.models import common as cm
    from repro_torch.models import xlstm as xlstm_mod

    b, s = batch["tokens"].shape
    cache = model.init_cache(b, s, torch.float32, "cuda")
    targets = {"associative_scan": (cm, "associative_scan"),
               "mlstm_chunk": (xlstm_mod, "_mlstm_chunk")}
    with torch.inference_mode(), _timed_calls(torch, targets) as events:
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        model.prefill(params, batch, cache, hook)
        t1.record()
        torch.cuda.synchronize()
    total = t0.elapsed_time(t1)
    out = {"prefill_ms": total}
    for label, evs in events.items():
        ms = sum(a.elapsed_time(z) for a, z in evs)
        out[f"{label}_calls"] = len(evs)
        out[f"{label}_ms"] = ms
        out[f"{label}_share"] = ms / total
    return out


def _decode_vs_forward(torch, model, params, hook, tokens, k: int) -> dict:
    """Prefill S - k tokens, then k decode steps of ``tokens``' own next
    tokens, each step's logits against the forward's at the same position:
    through the kernels within DECODE_VS_FORWARD_TOL * max|logit|, and with
    every packed matmul on qmm's plain backend within
    DECODE_VS_FORWARD_PLAIN_TOL * max|logit| (the cached path's own
    error, without the kernels' rounding). The first step is also taken
    from a fresh cache (the state a step sees when prefill or decode does
    not write it into the cache's views): it must miss the limit."""
    B, S = tokens.shape
    plain = copy.copy(hook)
    plain.packed_backend = "torch"
    out = {"steps": k}
    for tag, h, limit in (("", hook, DECODE_VS_FORWARD_TOL),
                          ("plain_", plain, DECODE_VS_FORWARD_PLAIN_TOL)):
        with torch.inference_mode():
            full, _ = model.forward(params, {"tokens": tokens}, h)
            if not tag:
                pos = torch.full((B,), S - k, dtype=torch.int32, device="cuda")
                lost, _ = model.decode_step(params, tokens[:, S - k:S - k + 1],
                                            model.init_cache(B, S, torch.float32, "cuda"),
                                            pos, h)
                lost = float((lost - full[:, S - k]).abs().max())
            cache = model.init_cache(B, S, torch.float32, "cuda")
            lg, cache = model.prefill(params, {"tokens": tokens[:, :S - k]}, cache, h)
            errs = [float((lg - full[:, S - k - 1]).abs().max())]
            for t in range(S - k, S):
                pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
                lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache, pos, h)
                errs.append(float((lg - full[:, t]).abs().max()))
        amax = float(full.abs().max())
        tol = limit * amax
        del full, cache
        if not all(math.isfinite(e) for e in errs) or max(errs) > tol:
            fail(f"{model.cfg.name}: prefill + decode ({tag or 'kernels_'}path) differ "
                 f"from the forward at the same positions: {errs} (limit {tol:.3e})")
        out.update({f"{tag}max_abs_err": max(errs), f"{tag}per_position": errs,
                    f"{tag}limit": tol, f"{tag}max_abs_logit": amax})
    if not lost > out["limit"]:
        fail(f"{model.cfg.name}: a decode step from a fresh cache is within the limit "
             f"({lost:.3e} <= {out['limit']:.3e}): the check cannot see a lost state")
    out["fresh_cache_err"] = lost
    return out


def _packed_linears(art) -> int:
    """Packed matmuls of one forward step: every (stacked) packed node of
    the blocks once per layer, plus the head."""
    from repro_torch.interop import flatten_paths

    n = 0
    for path, leaf in flatten_paths(art.params).items():
        if path.endswith("/qscale"):
            n += leaf.shape[0] if path.split("/")[0] != "head" else 1
    return n


def _serve_recurrent(torch, tag, cfg, model, art, qm_kernel, serve) -> dict:
    """The fixed batch (8 x 64 prompt, 32 generated) from the packed
    artifact: every matmul of the two prefills (warm-up and timed) on K2's
    tensor-core tile and of the 32 decode steps on K1's decode body,
    counted; the plain path replays the tokens; prefill + decode against
    the forward on the card; the scans' and mLSTM chunks' share of a
    prefill."""
    from repro_torch.data import Corpus, CorpusConfig

    prompts = Corpus(CorpusConfig(vocab=cfg.vocab)).sample(8, 64, seed=7)
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    n_lin = _packed_linears(art)
    (gen_toks, sst), served, bodies = _counted({"qmatmul": qm_kernel}, lambda:
                                               serve.run_prefill_decode(
        model, art.params, batch, batch_size=8, prompt_len=64, gen_len=32,
        hook=art.hook(), tag=tag))
    # a prefill's head runs on the last token only: 8 rows, K1
    want = {"qgemv": 32 * n_lin + 2, "qmatmul": 2 * (n_lin - 1)}
    if ({k: served[k] for k in want} != want
            or bodies["qgemv"]["gemv_tc"] != served["qgemv"]
            or bodies["qmatmul"]["tc"] != served["qmatmul"]):
        fail(f"serving {tag}: launches {served} (expected {want}: {n_lin} packed "
             f"matmuls a step), bodies {bodies}")
    err, tol, agree = _kernel_vs_plain(torch, model, art.params, batch, gen_toks, tag)
    tokens = torch.cat([batch["tokens"], gen_toks[:, :DECODE_VS_FORWARD_STEPS]], 1)
    dvf = _decode_vs_forward(torch, model, art.params, art.hook(), tokens,
                             DECODE_VS_FORWARD_STEPS)
    shares = _prefill_shares(torch, model, art.params, art.hook(), batch)
    distinct = len(torch.unique(gen_toks))
    print(f"[{tag} serve] kernel launches {served} ({n_lin} packed matmuls a step), "
          f"bodies {bodies['qmatmul']} / {bodies['qgemv']}; logits kernel vs plain: max "
          f"abs err {err:.3e} (tol {tol:.3e}); greedy token agreement {agree:.4f}; "
          f"{distinct} distinct tokens; prefill + {dvf['steps']} decode steps vs the "
          f"forward: max abs err {dvf['max_abs_err']:.3e} (limit {dvf['limit']:.3e}; on "
          f"qmm's plain backend {dvf['plain_max_abs_err']:.3e}, limit "
          f"{dvf['plain_limit']:.3e}; a step from a fresh cache "
          f"{dvf['fresh_cache_err']:.3e}); "
          f"prefill {sst['t_prefill'] * 1e3:.2f} ms ({sst['prefill_tok_s']:.1f} tok/s), "
          f"decode {sst['t_decode'] * 1e3 / 31:.2f} ms a step ({sst['tok_s']:.1f} tok/s); "
          f"one prefill between CUDA events {shares['prefill_ms']:.2f} ms, of it the "
          f"associative scans {shares['associative_scan_ms']:.2f} ms "
          f"({shares['associative_scan_share']:.3f}, {shares['associative_scan_calls']} "
          f"calls) and the mLSTM chunks {shares['mlstm_chunk_ms']:.2f} ms "
          f"({shares['mlstm_chunk_share']:.3f}, {shares['mlstm_chunk_calls']} calls)")
    if distinct < MIN_DISTINCT_TOKENS:
        fail(f"serving {tag}: the greedy tokens hardly vary ({distinct} distinct)")
    return {"launches": served, "bodies": bodies, "packed_matmuls_a_step": n_lin,
            "logits_max_abs_err": err, "logits_tol": tol, "token_agreement": agree,
            "decode_vs_forward": dvf, "prefill_shares": shares, "stats": sst,
            "decode_ms_a_step": sst["t_decode"] * 1e3 / 31,
            "prefill_ms": sst["t_prefill"] * 1e3}


def _calibrate_recurrent(torch, tag, cfg, model, params, fq_kernel, fq_ref, qm_kernel,
                         serve, workdir: Path):
    """BRECQ W4 through ``repro_torch.core.quantize`` (block units,
    RECURRENT_SEQS x CALIB_LEN tokens, minibatch 8, RECURRENT_ITERS a block,
    streamed Fisher), every K5 call shadowed by its plain version; BRECQ
    closer to FP than RTN on held-out logits; export, verified load, block
    weights equal to params_q bit for bit. Returns (loaded artifact, the
    calibration's record)."""
    from repro_torch.core import ReconConfig, quantize, rtn_on_scales
    from repro_torch.data import Corpus, CorpusConfig, make_batches

    corpus = Corpus(CorpusConfig(vocab=cfg.vocab))
    calib = make_batches(corpus, RECURRENT_SEQS // 8, 8, CALIB_LEN, seed=1)
    held = {k: t.cuda() for k, t in
            make_batches(corpus, 1, HELDOUT_SEQS, CALIB_LEN, seed=2)[0].items()}
    rc = ReconConfig(w_bits=4, iters=RECURRENT_ITERS, calib_bs=8)
    res, launches, shadow, others, wall, peak = _counted_fq(
        torch, fq_kernel, fq_ref, qm_kernel, lambda: quantize(model, params, calib, rc))
    st = res.stats
    expect, _ = _fq_expected(model, res)
    print(f"[{tag}] {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}), W4, {RECURRENT_SEQS}x{CALIB_LEN} tokens, iters {rc.iters}, "
          f"calib_bs {rc.calib_bs}: calib_wall_s {st['calib_wall_s']:.2f}, fisher_wall_s "
          f"{st['fisher_wall_s']:.2f}, calib_iters_per_s {st['calib_iters_per_s']:.1f}, "
          f"calib_peak_bytes {st['calib_peak_bytes']} (device peak {peak} B); wall "
          f"{wall:.2f}s; {st['n_units']} units; fakequant launches {launches} (expected "
          f"{expect}); shadowed calls {shadow['calls']}, mismatches "
          f"{shadow['mismatches']}; unit retries {st['unit_retries']}, fallbacks "
          f"{st['unit_fallbacks']}, OOM halvings {st['unit_oom_halvings']}")
    if launches != expect:
        fail(f"{tag} calibration launched fakequant {launches} times, expected {expect}")
    if any(others.values()):
        fail(f"{tag} calibration launched packed-matmul kernels: {others}")
    if shadow["mismatches"] or shadow["calls"] != launches:
        fail(f"fakequant against its plain version during {tag} calibration: {shadow}")
    for u in st["units"]:
        print(f"[{tag}] unit {u['unit']}: {u['paths']} weights, rtn_recon_mse "
              f"{u['rtn_recon_mse']:.4e} final_recon_mse {u['final_recon_mse']:.4e} "
              f"retries {u['retries']} fallback {u['fallback']} opt_wall_s "
              f"{u['opt_wall_s']:.2f}")

    rtn_params = rtn_on_scales(model, params, res, held)
    with torch.no_grad():
        fp = model.forward(params, held)[0]
        mse = {"brecq": _logits_mse(torch, model, fp, held, res.params_q),
               "rtn": _logits_mse(torch, model, fp, held, rtn_params),
               "fp_mean_square": float(torch.mean(fp ** 2))}
    del rtn_params, fp
    print(f"[{tag}] held-out logits MSE vs FP ({HELDOUT_SEQS}x{CALIB_LEN}): BRECQ-W4 "
          f"{mse['brecq']:.4e}, RTN-W4 {mse['rtn']:.4e} (ratio "
          f"{mse['brecq'] / mse['rtn']:.4f}; FP logits mean square "
          f"{mse['fp_mean_square']:.4e})")
    if not all(math.isfinite(x) for x in mse.values()) or mse["brecq"] >= mse["rtn"]:
        fail(f"{tag}: BRECQ-W4 logits are not closer to FP than RTN-W4's: {mse}")

    t0 = time.perf_counter()
    art, n_blocks = _export_verified(torch, model, res, serve, workdir / f"{tag}_w4", tag)
    print(f"[{tag}] artifact {art.nbytes()} B ({art.manifest['family']}) exported, saved "
          f"and loaded verified in {time.perf_counter() - t0:.1f}s; the {n_blocks} "
          f"block weights equal params_q bit for bit")
    keep = ("calib_wall_s", "fisher_wall_s", "calib_iters_per_s", "calib_peak_bytes",
            "unit_retries", "unit_fallbacks", "unit_oom_halvings", "unit_cache")
    return art, {"launches": launches, "expected_launches": expect, "shadow": shadow,
                 "stats": {k: st[k] for k in keep}, "device_peak_bytes": peak,
                 "wall_s": wall, "logits_mse": mse, "artifact_bytes": art.nbytes(),
                 "units": [{k: u[k] for k in ("unit", "paths", "rtn_recon_mse",
                                              "final_recon_mse", "retries", "fallback",
                                              "opt_wall_s")} for u in st["units"]]}


def phase_xlstm(torch, fq_kernel, fq_ref, qm_kernel, serve, workdir: Path) -> dict:
    """xlstm-350m at full width and depth (24 layers: 4 blocks of 5 mLSTM +
    1 sLSTM), random weights from seed 0: BRECQ W4 calibration with every K5
    call shadowed, BRECQ against RTN on held-out logits, export and verified
    load, and the fixed batch from the packed artifact through K2 and K1,
    replayed by the plain path and held against the forward."""
    from repro_torch.deploy import tree_bytes
    from repro_torch.models import get_model

    t_phase = time.perf_counter()
    cfg, model = get_model("xlstm_350m")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    fp_bytes = tree_bytes(params)
    art, calib = _calibrate_recurrent(torch, "xlstm", cfg, model, params, fq_kernel,
                                      fq_ref, qm_kernel, serve, workdir)
    del params
    torch.cuda.empty_cache()
    served = _serve_recurrent(torch, "xlstm", cfg, model, art, qm_kernel, serve)
    del art
    torch.cuda.empty_cache()
    return {"calib": calib, "serve": served, "fp_bytes": fp_bytes,
            "phase_wall_s": time.perf_counter() - t_phase}


def phase_hymba(torch, fq_kernel, fq_ref, qm_kernel, serve, workdir: Path) -> dict:
    """hymba-1.5b at full width. At full depth (32 layers): RTN W4 packed on
    the card and the fixed batch through K2 and K1, replayed by the plain
    path and held against the forward. Cut to HYMBA_CALIB_LAYERS: BRECQ W4
    with every K5 call shadowed, export, verified load, and the calibrated
    artifact served the same way."""
    from repro_torch.deploy import rtn_artifact, tree_bytes
    from repro_torch.models import build_model, get_config

    t_phase = time.perf_counter()
    cfg = get_config("hymba_1_5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    fp_bytes = tree_bytes(params)
    t0 = time.perf_counter()
    art = rtn_artifact(params, 4, None, cfg=cfg)
    del params
    torch.cuda.empty_cache()
    print(f"[hymba] {cfg.name} at full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.hd}, window "
          f"{cfg.hymba_window}, SSM d_inner {int(cfg.d_model * cfg.ssm_expansion)} state "
          f"{cfg.ssm_state}, d_ff {cfg.d_ff}, vocab {cfg.vocab}): RTN W4 artifact "
          f"{art.nbytes()} B vs fp {fp_bytes} B, made on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    full = _serve_recurrent(torch, "hymba", cfg, model, art, qm_kernel, serve)
    full.update(artifact_bytes=art.nbytes(), fp_bytes=fp_bytes)
    del art
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=HYMBA_CALIB_LAYERS)
    model = build_model(cut)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    art, calib = _calibrate_recurrent(torch, "hymba_calib", cut, model, params,
                                      fq_kernel, fq_ref, qm_kernel, serve, workdir)
    del params
    torch.cuda.empty_cache()
    calib["serve"] = _serve_recurrent(torch, "hymba_calib", cut, model, art, qm_kernel,
                                      serve)
    calib["reduced"] = {"n_layers": [cfg.n_layers, HYMBA_CALIB_LAYERS],
                        "why": "chip time: the width stays, the depth is cut"}
    del art
    torch.cuda.empty_cache()
    return {"full_depth": full, "calib": calib,
            "phase_wall_s": time.perf_counter() - t_phase}


TIMED_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_f32_ms")


def _layer(rows, shapes, **sel) -> dict:
    """The rows matching ``sel``, summed over one layer's calls (``shapes``:
    (K, N) -> calls of that shape)."""
    rows = [r for r in rows if all(r.get(k) == v for k, v in sel.items())]
    tot = {key: sum(shapes[(r["K"], r["N"])] * r[key] for r in rows) for key in TIMED_KEYS}
    by = {r["bound_by"] for r in rows}
    tot["bound_by"] = by.pop() if len(by) == 1 else "bytes"
    tot["bodies"] = sorted({f"{r['body']}/{r['tile']}" if r.get("tile") else r["body"]
                            for r in rows})
    return tot


def kernel_line(errs, rows, kv_err, kv_timed, launches, bodies, moe, fq,
                long_engine, calib_moe, mixed, family, recurrent, trained,
                deploy, dist) -> dict:
    """One entry per kernel, ``launches`` from the engine's main path and
    every time at that path's shapes. For qgemv/qmatmul: one layer's 7
    matmuls at the engine's W4 per-channel setting (the decode step's M=8
    for qgemv, the prefill chunk's M=32 for qmatmul, and the fixed batch's
    M=512 as added fields), summed over the layer's shapes; qmatmul_grouped
    likewise per MoE layer at M 8 and, as added fields, M 64. For
    kv_decode: one call of the paged entry at the engine's decode shape, and
    as added fields the dense entry at that shape, at long caches and at hd
    120, and the launches by entry and by split on the engine and
    long-context engine paths.
    ``body_launches``:
    the main path's launches of each body. ``bound_ms`` follows the
    arithmetic of the body that ran (bytes against three bf16 passes for
    the decode body, two TF32 or three bf16 passes for the tiles);
    ``bound_f32_ms`` is the f32 CUDA-core bound earlier rows used. The
    launches of the later paths stand beside: qgemv's and qmatmul's while
    the cost table is timed, serving the calibrated mixed artifact and
    serving under ``--budget-decode-ms``; qmatmul_grouped's serving the
    calibrated MoE artifact; fakequant's in the MoE calibration (on stacks
    of experts apart, with its time at one expert leaf) and in the mixed
    phase. The attention families' paths stand beside too (``family``):
    every kernel's launches serving whisper-small, the VLM and the dense
    engines, fakequant's calibrating whisper, and the times at their new
    shapes (qgemv ``vlm_mlp_*`` on 8,192 x 28,672; qmatmul ``whisper_enc_*``
    at M 12,000 and ``vlm_xkv_*`` at M 8,192, K 8,192; kv_decode
    ``danube_*``, ``gemma3_*`` and ``internlm2_*`` on the paged entry). So do
    the recurrent families' (``recurrent``): K1's and K2's launches serving
    xlstm-350m and hymba-1.5b, K5's calibrating them, and the times of all
    three at their new shapes (``recurrent_shapes``). The trained model's
    path (``trained``): K5's launches calibrating it at W4 (its W2
    calibration is the main path's), K1's and K2's serving its W4
    artifact. The deployment tables' (``deploy``): K1's, K2's and K4's
    launches in tables 6, 7 and 8 at full width. The dist phase's
    (``dist``): K1's and K2's launches on each rank serving under
    ``Plan("tp")`` on two ranks, and their times at one layer's half-N
    shapes (``half_n_*``: M 8 for K1, M 512 for K2, W4 per-channel)."""
    meta = {"qgemv": ("src/repro/kernels/qmatmul/kernel.py:140", 8),
            "qmatmul": ("src/repro/kernels/qmatmul/kernel.py:83", 32)}
    out = []
    for name, (replaces, m) in meta.items():
        tot = _layer(rows, SLICE_SHAPES, kernel=name, bits=4, group=None, M=m)
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
            "bound_f32_ms": tot["bound_f32_ms"],
            "shapes": f"one layer: 4x768x768, 2x768x2048, 1x2048x768; W4 "
                      f"per-channel; M={m}"}
        entry["body"] = tot["bodies"]
        entry["body_launches"] = bodies[name]
        entry.update({"cost_table_launches": mixed["cost_table_launches"][name],
                      "mixed_launches": mixed["serve"]["launches"][name],
                      "budget_decode_ms_launches": mixed["decode_ms"]["launches"][name]})
        if name == "qmatmul":
            big = _layer(rows, SLICE_SHAPES, kernel=name, bits=4, group=None, M=512)
            entry.update({f"m512_{k}": big[k] for k in (*TIMED_KEYS, "bound_by")})
            entry["m512_body"] = big["bodies"]
        entry.update(_family_fields(family, name))
        entry.update(_recurrent_fields(recurrent, name))
        entry["trained_w4_launches"] = trained["serve"]["launches"][name]
        entry["deploy_launches"] = {t: deploy["launches"][t][name] for t in ("t6", "t7", "t8")}
        entry["dist_launches_per_rank"] = [r["launches"][name] for r in dist["serve"]["ranks"]]
        entry.update({f"half_n_{k}": dist["half_n"][name][k]
                      for k in (*TIMED_KEYS, "bound_by")})
        out.append(entry)
    t = kv_timed["paged"]
    kv = {
        "name": "kv_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/kvattn/csrc/kvattn.cu",
        "replaces": "src/repro/kernels/kvattn/kernel.py:70",
        "launches": launches["kv_decode"], "max_abs_err": kv_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "body": t["body"], "split": t["split"], "body_launches": bodies["kv_decode"],
        "entry_launches": bodies["kv_decode_entry"],
        "split_launches": bodies["kv_decode_split"],
        "gather_dense_ms": t["gather_dense_ms"],
        "shapes": f"B={t['B']} H={t['H']} K={t['K']} hd={t['hd']} S={t['S']} in pages of "
                  f"{t['page_size']}, two idle rows: the paged entry the engine takes "
                  f"(gather_dense_ms: the gather + casts + dense kernel it replaced); "
                  f"dense_* the dense entry at the same shape, s1024_*/s2048_*/long_* "
                  f"at S 1024/2048/4096 and hd120_* at H 32 over K 8 of 120 the dense "
                  f"entry"}
    for label in ("engine", "s1024", "s2048", "long", "hd120"):
        prefix = "dense" if label == "engine" else label
        kv.update({f"{prefix}_{k}": kv_timed[label][k]
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms", "split")})
    kv.update({"long_engine_launches": long_engine["launches"]["kv_decode"],
               "long_engine_entry_launches": long_engine["bodies"]["kv_decode_entry"],
               "long_engine_split_launches": long_engine["bodies"]["kv_decode_split"]})
    kv.update(_family_fields(family, "kv_decode"))
    kv["deploy_launches"] = {t: deploy["launches"][t]["kv_decode"] for t in ("t6", "t7", "t8")}
    kv["deploy_t7_entry_launches"] = deploy["bodies"]["t7"]["kv_decode_entry"]
    out.append(kv)
    dec = _layer(moe["rows"], MOE_SHAPES, M=8)
    pre = _layer(moe["rows"], MOE_SHAPES, M=64)
    entry = {
        "name": "qmatmul_grouped", "route": "cuda",
        "source": "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul/kernel.py:194",
        "launches": moe["launches"]["qmatmul_grouped"],
        "max_abs_err": moe["err"], "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "bound_f32_ms": dec["bound_f32_ms"],
        "body": dec["bodies"],
        "shapes": f"one deepseek-moe-16b MoE layer: 2x E{MOE_E} 2048x1408, 1x "
                  f"E{MOE_E} 1408x2048; W4 per-channel; M=8 per expert (m64_*: "
                  f"M=64)",
        "launches_from": "the MoE fixed-batch serve"}
    entry.update({f"m64_{k}": pre[k] for k in (*TIMED_KEYS, "bound_by")})
    entry["m64_body"] = pre["bodies"]
    entry["body_launches"] = moe["bodies"]["qmatmul_grouped"]
    entry["calib_moe_launches"] = calib_moe["serve"]["launches"]["qmatmul_grouped"]
    entry["calib_moe_body_launches"] = calib_moe["serve"]["bodies"]["qmatmul_grouped"]
    out.append(entry)
    tot = {key: sum(SLICE_SHAPES[(r["K"], r["N"])] * r[key] for r in fq["rows"])
           for key in ("ms", "plain_ms", "bound_ms")}
    out.append({
        "name": "fakequant", "route": "cuda",
        "source": "src/repro_torch/kernels/fakequant/csrc/fakequant.cu",
        "replaces": "src/repro/kernels/fakequant/kernel.py:38",
        "launches": fq["launches"], "max_abs_err": fq["err"], "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": fq["rows"][0]["bound_by"], "library_ms": None,
        "shapes": "one brecq block's weights: 4x768x768, 2x768x2048, 1x2048x768; "
                  "hard, W2, (1, N) scales; experts_*: one deepseek-moe-16b expert "
                  "leaf, 64x2048x1408 as its (64*2048, 1408) view",
        "launches_from": "the full-width W2 calibration of the trained model",
        "trained_w4_launches": trained["launches"],
        "moe_launches": calib_moe["launches"],
        "moe_expert_launches": calib_moe["view_launches"]["experts"],
        "mixed_launches": sum(mixed["fq_launches"].values()),
        "whisper_launches": family["whisper"]["launches"],
        **{f"experts_{k}": fq["experts"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        **_recurrent_fields(recurrent, "fakequant")})
    return {"kernels": out}


# the dist phase: steps of the int8 data-parallel run and its global batch
DIST_STEPS = 20
DIST_BATCH = (16, 128)
# int8 - f32 loss at each step of those runs, both through
# make_dp_train_step from the same start, lies within -DIST_LOSS_BELOW ..
# DIST_LOSS_ABOVE: 1.5 x the largest reading on each side over seeds 0-4
# of scripts/dp_int8_gap.py on the H100 (+0.1583 at step 4, -0.2495 at
# step 19). On every seed int8 lags early (+0.10 .. +0.16 at steps 2-4) and
# leads late (-0.15 .. -0.25 at steps 17-19)
DIST_LOSS_ABOVE = 0.25
DIST_LOSS_BELOW = 0.375
DIST_TRAIN_BATCH = (8, 128)  # the sharded train steps' global batch
# the sharded train steps against one rank's, bf16 compute: each leaf's
# gradient (Adam's first moment) within this share of its norm (a gradient
# on the wrong columns reads 1.4; bf16 noise 3.1e-3 under dp, 1.8e-2 under
# tp on the H100)
DIST_GRAD_REL = 5e-2
DIST_SERVE = (8, 64, 32)  # batch, prompt, greedy tokens
DIST_MESH = (1, 2)  # data x model
# (arch, shape, --quant) cells of the dry run on the (32, 8) mesh of 256 ranks
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k", None), ("tinyllama_1_1b", "decode_32k", 4))
HALF_N_SHAPES = {(k, n // 2): c for (k, n), c in SLICE_SHAPES.items()}
# seconds: the gloo probe's cases (a case with no answer counts as not
# taken), and the ranks' run and each dry-run cell (each took 65 s or less
# on the H100; a hang fails the run well inside its time limit)
DIST_PROBE_S = 120
DIST_WAIT_S = 300


def _dist_probe(run: dict) -> dict:
    """The gloo probe in its own processes: which of the functional
    collectives DTensor calls gloo takes on CUDA tensors in this torch (the
    int8 step's ``torch.distributed.all_reduce`` is held by its own check;
    ``scripts/dist_probe.py`` alone probes both APIs). A case that neither
    answers nor crashes within DIST_PROBE_S counts as not taken."""
    proc = subprocess.Popen([sys.executable, str(ROOT / "scripts" / "dist_probe.py"),
                             "--device", "cuda", "--api", "functional", "--deadline",
                             str(DIST_PROBE_S)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC)})
    run["probe"] = proc
    stdout, stderr = proc.communicate(timeout=DIST_PROBE_S + 60)
    if proc.returncode:
        raise RuntimeError(f"scripts/dist_probe.py failed:\n{stdout[-2000:]}\n"
                           f"{stderr[-3000:]}")
    return json.loads(stdout.strip().splitlines()[-1])["gloo"]


def _dryrun_start(arch: str, shape: str, quant, out: Path):
    """Start one dry-run cell in its own process (CPU work only)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "single", "--out", str(out)]
    if quant:
        cmd += ["--quant", str(quant), "--tag", f"w{quant}"]
    out.mkdir(parents=True, exist_ok=True)
    log = out / f"{arch}_{shape}_{quant}.log"  # a file: a pipe left unread could fill
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": str(SRC),
                                     "OMP_NUM_THREADS": "1"})
    return arch, shape, quant, time.time(), proc, log


def _dryrun_result(started) -> dict:
    arch, shape, quant, t0, proc, log = started
    try:
        proc.wait(timeout=DIST_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        fail(f"dry run {arch} {shape}: rc {proc.returncode}\n{log.read_text()[-3000:]}")
    tag = f"_w{quant}" if quant else ""
    art = log.parent / f"{arch}_{shape}_single{tag}.json"
    d = json.loads(art.read_text())
    d["wall_s"] = art.stat().st_mtime - t0  # written as the cell ends
    if not (d["flops_per_rank"] > 0 and isinstance(d["fits_80gb"], bool)):
        fail(f"dry run {arch} {shape}: no FLOPs or no fit verdict")
    print(f"[dist] dry run {arch} {shape}{tag} on {d['n_chips']} ranks "
          f"{d['mesh_shape']} ({d['strategy']}): per rank args "
          f"{d['argument_bytes_total'] / 1e9:.3f} GB {d['argument_bytes']}, peak "
          f"{d['peak_bytes'] / 1e9:.3f} GB, fits_80gb {d['fits_80gb']}, FLOPs "
          f"{d['flops_per_rank']:.4g}, bytes {d['bytes_per_rank']:.4g}, collectives "
          f"{d['collective_counts']} ({d['collective_bytes_total'] / 1e9:.3f} GB), "
          f"gathers {d['gathers']}, bound {d['roofline']['bottleneck']} "
          f"(compute {d['roofline']['compute_s']:.4g} s, memory "
          f"{d['roofline']['memory_s']:.4g} s, collective {d['roofline']['collective_s']:.4g} s); "
          f"trace {d['trace_s']}s, {d['wall_s']:.0f}s")
    return d


def dist_start() -> dict:
    """Start the dist phase's gloo probe (its own processes, light on the
    card) and a thread that waits on it, then on ``dist_go``, then runs one
    spawn of two ranks with the three checks. ``phase_dist`` waits for them
    and holds their results; ``dist_stop`` stops whatever is left."""
    import threading

    from repro_torch.dist import checks, spawn

    run: dict = {"t0": time.perf_counter(), "probe": None, "dry": [],
                 "go": threading.Event(), "cancel": False}

    def ranks() -> None:
        try:
            t0 = time.perf_counter()
            run["gloo"] = _dist_probe(run)
            run["probe_s"] = time.perf_counter() - t0
            # DTensor calls the functional collectives: those gloo cannot run
            # on CUDA tensors go through pinned host memory (dist/staging.py)
            run["staged_ops"] = [op for op, v in run["gloo"]["functional"].items()
                                 if not v.startswith("ok")]
            run["go"].wait()
            if run["cancel"]:
                return
            t0 = time.perf_counter()
            B, S, G = DIST_SERVE
            run["ranks"] = spawn.run_ranks(checks.several, 2, [
                ("dp_int8", ("brecq_lm_100m", False, "cuda", *DIST_BATCH, DIST_STEPS)),
                ("train_steps", ("brecq_lm_100m", False, "cuda", DIST_MESH,
                                 ("dp", "tp", "fsdp", "zero3"), *DIST_TRAIN_BATCH)),
                ("serve", ("brecq_lm_100m", False, "cuda", DIST_MESH, 4, B, S, G))],
                stage=run["staged_ops"], timeout=DIST_WAIT_S)
            run["ranks_s"] = time.perf_counter() - t0
            run["staged_calls"] = list(spawn.LAST_STAGED)
        except BaseException:  # phase_dist fails with it
            run["error"] = traceback.format_exc()
        run["done_s"] = time.perf_counter() - run.get("t_go", run["t0"])

    run["thread"] = threading.Thread(target=ranks, name="dist", daemon=True)
    run["thread"].start()
    return run


def dist_go(run: dict, workdir: Path) -> None:
    """Start the dry-run cells (CPU only) and let the two ranks start once
    the probe has answered."""
    run["t_go"] = time.perf_counter()
    run["dry"] = [_dryrun_start(a, sh, q, workdir / "dryrun_torch")
                  for a, sh, q in DRYRUN_CELLS]
    run["go"].set()


def dist_stop(run: dict) -> None:
    """Stop every process ``dist_start`` and ``dist_go`` started that is
    still running (a failed phase before ``phase_dist``, or a failed check
    in it)."""
    import multiprocessing

    run["cancel"] = True
    run["go"].set()
    procs = [run["probe"]] + [started[4] for started in run["dry"]]
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    for child in multiprocessing.active_children():  # the spawned ranks
        child.kill()
        child.join()


# phases that the whole run starts, each in a process of its own
# (``--phase``), beside whisper and dense: each times no kernel, and each
# result comes back pickled. The kernels load from the build's files.
SUB_WAIT_S = 600


def _sub_engine_long(torch, workdir: Path) -> dict:
    from repro_torch.kernels.kvattn import kernel as kv_kernel
    from repro_torch.kernels.qmatmul import kernel
    from repro_torch.launch import serve

    return phase_engine_long(torch, serve, {"qmatmul": kernel, "kvattn": kv_kernel},
                             workdir)


def _sub_recurrent(torch, workdir: Path) -> dict:
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant import ref as fq_ref
    from repro_torch.kernels.qmatmul import kernel
    from repro_torch.launch import serve

    return {"xlstm": phase_xlstm(torch, fq_kernel, fq_ref, kernel, serve, workdir),
            "hymba": phase_hymba(torch, fq_kernel, fq_ref, kernel, serve, workdir)}


SUB_PHASES = {"engine_long": _sub_engine_long, "recurrent": _sub_recurrent}


QUICKSTART = ROOT / "examples" / "torch_quickstart.py"


def quickstart_start(workdir: Path) -> dict:
    """Start ``examples/torch_quickstart.py`` with QUICKSTART_SMOKE=1 on the
    card, in a process of its own (its output to a file)."""
    log = workdir / "quickstart.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(QUICKSTART)], stdout=f,
                                stderr=subprocess.STDOUT, cwd=str(ROOT),
                                env={**os.environ, "PYTHONUNBUFFERED": "1",
                                     "QUICKSTART_SMOKE": "1", "PYTHONPATH": str(SRC)})
    return {"name": "quickstart", "proc": proc, "log": log, "t0": time.perf_counter()}


def quickstart_result(sub: dict) -> dict:
    """Wait for the quickstart, print its output and gate on its exit code
    and on the BRECQ-W2 < RTN-W2 perplexities it prints."""
    import re

    proc = sub["proc"]
    try:
        proc.wait(timeout=SUB_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = sub["log"].read_text()
    print(text, end="", flush=True)
    secs = time.perf_counter() - sub["t0"]
    print(f"[quickstart] ran in a process of its own in {secs:.1f}s "
          f"(exit {proc.returncode})", flush=True)
    if proc.returncode:
        fail(f"examples/torch_quickstart.py exited {proc.returncode}")
    ppl = {k: float(m.group(1)) for k, pat in (("rtn_w2", r"RTN  W2  : ppl ([0-9.]+)"),
                                               ("brecq_w2", r"BRECQ W2 : ppl ([0-9.]+)"),
                                               ("fp", r"FP32     : ppl ([0-9.]+)"))
           for m in [re.search(pat, text)] if m}
    if set(ppl) != {"rtn_w2", "brecq_w2", "fp"}:
        fail(f"the quickstart printed no FP, RTN-W2 and BRECQ-W2 perplexities: {ppl}")
    print(f"[quickstart] FP ppl {ppl['fp']}, BRECQ-W2 {ppl['brecq_w2']} < RTN-W2 "
          f"{ppl['rtn_w2']}: {ppl['brecq_w2'] < ppl['rtn_w2']}")
    if not ppl["brecq_w2"] < ppl["rtn_w2"]:
        fail(f"the quickstart's BRECQ-W2 ppl {ppl['brecq_w2']} is not below its RTN-W2 "
             f"{ppl['rtn_w2']}")
    return {**ppl, "seconds": secs}


def _plain(obj):
    """``obj`` as dicts, lists, tuples and scalars (dict keys kept as they
    are), so that a phase's record pickles with nothing of torch in it."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map(_plain, obj)) if type(obj) in (list, tuple) else [
            _plain(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "tolist"):  # tensors and numpy values
        return _plain(obj.tolist())
    return str(obj)


def sub_start(name: str, workdir: Path) -> dict:
    """Start ``chip_smoke.py --phase name`` (its output to a file, printed
    when it ends)."""
    out, log = workdir / f"phase_{name}.pkl", workdir / f"phase_{name}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "--phase", name, "--phase-out", str(out)],
                                stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONUNBUFFERED": "1"})
    return {"name": name, "proc": proc, "out": out, "log": log,
            "t0": time.perf_counter()}


def sub_result(sub: dict):
    """Wait for a ``sub_start`` process, print its output, and return its
    result; fail if it failed."""
    import pickle

    proc = sub["proc"]
    try:
        proc.wait(timeout=SUB_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(sub["log"].read_text(), end="", flush=True)
    print(f"[{sub['name']}] ran in a process of its own in "
          f"{time.perf_counter() - sub['t0']:.1f}s (exit {proc.returncode})", flush=True)
    if proc.returncode:
        fail(f"the {sub['name']} phase exited {proc.returncode}")
    return pickle.loads(sub["out"].read_bytes())


def phase_dist(torch, kernel, ref, pack, run: dict) -> dict:
    """Two ranks on the one card (module doc, 20), started by ``dist_go``:
    DP int8, the sharded train steps, packed TP serving on N shards; then,
    alone on the card, K1/K2 at half N; the dry run."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    run["thread"].join(timeout=DIST_PROBE_S + DIST_WAIT_S + 120)
    waited = time.perf_counter() - t_phase
    if run["thread"].is_alive():
        fail(f"the dist ranks gave no result in {time.perf_counter() - run['t0']:.0f}s")
    if "error" in run:
        fail(f"the dist ranks failed:\n{run['error']}")
    B, S, G = DIST_SERVE
    ranks = run["ranks"]
    out: dict = {k: run[k] for k in ("gloo", "staged_ops", "probe_s", "ranks_s",
                                     "staged_calls", "done_s")}
    out["waited_s"] = waited
    print(f"[dist] gloo on CUDA tensors: {out['gloo']}; staged through host memory: "
          f"{out['staged_ops'] or 'none'}")
    print(f"[dist] the probe took {out['probe_s']:.0f}s (beside calib_moe); beside "
          f"whisper and dense, two ranks ran the int8 DP, train and serve checks in "
          f"{out['ranks_s']:.0f}s, done {out['done_s']:.0f}s after they could start; "
          f"this phase waited {waited:.1f}s for them; collectives staged through host "
          f"memory per rank {out['staged_calls']}")
    dp = [r[0] for r in ranks]
    d = dp[0]
    for r in dp:
        if r["unequal"] or r["max_abs_diff"] > 0:
            fail(f"int8 all-reduce: {r['unequal']} of {r['elements']} g_hat elements "
                 f"differ from the reference arithmetic (max {r['max_abs_diff']:.3e})")
    print(f"[dist] int8 DP losses {[round(x, 4) for x in d['int8_losses']]}; f32 "
          f"{[round(x, 4) for x in d['f32_losses']]}")
    if not (d["int8_losses"][-1] < d["int8_losses"][0] and d["err_abs_sum"] > 0):
        fail(f"int8 DP: loss {d['int8_losses'][0]:.4f} -> {d['int8_losses'][-1]:.4f}, "
             f"error buffer sum {d['err_abs_sum']:.3e}")
    diffs = [a - b for a, b in zip(d["int8_losses"], d["f32_losses"])]
    if not -DIST_LOSS_BELOW <= min(diffs) <= max(diffs) <= DIST_LOSS_ABOVE:
        fail(f"int8 DP loss minus f32's {min(diffs):+.4f} .. {max(diffs):+.4f}, outside "
             f"-{DIST_LOSS_BELOW} .. +{DIST_LOSS_ABOVE}")
    out["dp_int8"] = {**d, "loss_gap": [min(diffs), max(diffs)]}
    print(f"[dist] int8 all-reduce == reference arithmetic on {d['elements']} gradient "
          f"elements (2 rounds); {DIST_STEPS} steps of {DIST_BATCH[0]}x{DIST_BATCH[1]}: "
          f"loss {d['int8_losses'][0]:.4f} -> {d['int8_losses'][-1]:.4f} (f32 "
          f"{d['f32_losses'][-1]:.4f}; int8 - f32 {min(diffs):+.4f} .. {max(diffs):+.4f}), {d['int8_s_per_step']*1e3:.0f} "
          f"ms/step; wire bytes/rank/step {d['wire_bytes']}")

    tr = ranks[0][1]
    for strat, r in tr.items():
        lim = 2 * r["lr"] * (1 + 1e-3) + 1e-7
        if (abs(r["loss"] - r["ref_loss"]) > 5e-3 * abs(r["ref_loss"])
                or abs(r["gnorm"] - r["ref_gnorm"]) > 2e-2 * r["ref_gnorm"]
                or r["max_param_diff"] > lim or r["m_rel"] > DIST_GRAD_REL):
            fail(f"make_train_step {strat}: {r}")
        if strat != "dp" and r["param_bytes"] + r["adam_bytes"] > 0.55 * (
                tr["dp"]["param_bytes"] + tr["dp"]["adam_bytes"]):
            fail(f"{strat} holds {r['param_bytes'] + r['adam_bytes']} bytes a rank, not "
                 f"about half of dp's {tr['dp']['param_bytes'] + tr['dp']['adam_bytes']}")
        print(f"[dist] train {strat:5s} on {DIST_MESH}: loss {r['loss']:.5f} (one rank "
              f"{r['ref_loss']:.5f}) gnorm {r['gnorm']:.4f} ({r['ref_gnorm']:.4f}) params "
              f"within {r['max_param_diff']:.2e} (<= 2 lr), {r['params_off']:.4%} off by "
              f"> 1e-6 (most in {r['params_off_leaf']}); gradients within {r['m_rel']:.3e} (Adam's m, per leaf); per "
              f"rank params "
              f"{r['param_bytes'] / 1e6:.1f} MB Adam {r['adam_bytes'] / 1e6:.1f} MB; "
              f"gathers {r['gathers']}; {r['s']:.1f}s")
    out["train"] = {"steps": tr}

    sv = [r[2] for r in ranks]
    for rank, r in enumerate(sv):
        # prefill: every layer's matmuls at M = B x S (K2), a packed head on
        # the last token at M = B (K1); each decode step: all at M = B (K1)
        n, h = r["packed_per_forward"], r["packed_heads"]
        want = {"qgemv": G * n + h, "qmatmul": n - h}
        got = {k: r["launches"][k] for k in want}
        halves = {w // 2 for w in r["whole_n"]}
        if got != want:
            fail(f"rank {rank}: packed launches {got}, expected {want}")
        if not all(int(k.rsplit("_N", 1)[1]) in halves for k in r["kernel_n"]):
            fail(f"rank {rank}: a packed launch off the N/2 shard: {r['kernel_n']}")
        if 2 * r["codes_bytes_rank"] != r["codes_bytes_whole"]:
            fail(f"rank {rank}: codes {r['codes_bytes_rank']} bytes of "
                 f"{r['codes_bytes_whole']}")
        lim = 1e-4 * r["max_abs_logit"] + 1e-5
        if r["max_abs_diff"] > lim:
            fail(f"rank {rank}: TP logits {r['max_abs_diff']:.3e} from the one-rank "
                 f"serve > {lim:.3e}")
        if not r["tokens_equal"] and r["min_top2_gap"] > 1e-3 * r["max_abs_logit"]:
            fail(f"rank {rank}: tokens differ at step {r['first_mismatch_step']} with no "
                 f"near tie (top-2 gap {r['min_top2_gap']:.3e})")
    r = sv[0]
    out["serve"] = {"ranks": sv}
    print(f"[dist] TP W4 serve {B}x{S}+{G} on {DIST_MESH}: per rank K2 "
          f"{r['launches']['qmatmul']} K1 {r['launches']['qgemv']} (expected "
          f"{r['packed_per_forward'] - r['packed_heads']} and {G} x "
          f"{r['packed_per_forward']} + {r['packed_heads']}) by N "
          f"{r['kernel_n']}; codes {r['codes_bytes_rank'] / 1e6:.2f} of "
          f"{r['codes_bytes_whole'] / 1e6:.2f} MB a rank; logits within "
          f"{r['max_abs_diff']:.3e} (limit {1e-4 * r['max_abs_logit'] + 1e-5:.3e}), "
          f"tokens equal {r['tokens_equal']}; decode step {r['decode_ms_tp']:.2f} ms "
          f"on 2 ranks vs {r['decode_ms_one_rank']:.2f} ms on one; gathers "
          f"{r['gathers']}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (k, n) in HALF_N_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        wp, sc = pack.rtn_pack_leaf(w, 4, None)
        for name, fn, plain, m in (("qgemv", kernel.qgemv, ref.qgemv_ref, 8),
                                   ("qmatmul", kernel.qmatmul, ref.qmatmul_ref, B * S)):
            x = torch.randn((m, k), generator=gen, device=dev)
            got_ = fn(x, wp, sc, bits=4)
            want_ = plain(x, wp, sc, 4)
            err = float((got_ - want_).abs().max())
            if err > tolerance(want_):
                fail(f"{name} at half N M={m} K={k} N={n}: err {err:.3e}")
            rows.append(_time_case(torch, name, fn, plain, ref, x, wp, sc, 4, None, m, k,
                                   n, err, err / max(float(want_.abs().max()), 1e-30)))
    out["half_n"] = {"rows": rows,
                     "qgemv": _layer(rows, HALF_N_SHAPES, kernel="qgemv"),
                     "qmatmul": _layer(rows, HALF_N_SHAPES, kernel="qmatmul")}

    out["dryrun"] = [_dryrun_result(started) for started in run["dry"]]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[dist] phase wall {out['wall_s']:.0f}s (after the phases it ran beside)")
    return out


def _recurrent_fields(recurrent, name) -> dict:
    """One kernel's added fields from the recurrent families' paths (K1, K2
    and K5): its launches serving (K1, K2) or calibrating (K5) xlstm-350m,
    hymba-1.5b at full depth and the calibrated hymba cut, and its times at
    the families' new shapes (a row a shape: K1 and K2 at W4, K5 hard at
    W2)."""
    x, h = recurrent["xlstm"], recurrent["hymba"]
    if name == "fakequant":
        out = {"xlstm_launches": x["calib"]["launches"],
               "hymba_launches": h["calib"]["launches"]}
    else:
        out = {"xlstm_launches": x["serve"]["launches"][name],
               "hymba_launches": h["full_depth"]["launches"][name],
               "hymba_calib_launches": h["calib"]["serve"]["launches"][name]}
    out["recurrent_max_abs_err"] = recurrent["kernels"]["errs"][name]
    keys = ("label", "M", "K", "N", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out["recurrent_shapes"] = [{k: r.get(k) for k in keys}
                               for r in recurrent["kernels"]["rows"][name]]
    return out


def _family_fields(family, name) -> dict:
    """One kernel's added fields from the attention families' paths: its
    launches on each (the kernel entry's body counts for the dense
    engines' kv_decode), and its times at the shapes they gave it."""
    dense = family["dense"]
    out = {"family_max_abs_err": family["kernels"]["errs"][name]}
    if name == "kv_decode":
        for arch, d in dense.items():
            out[f"{arch}_engine_launches"] = d["launches"]["kv_decode"]
            out[f"{arch}_engine_body_launches"] = d["bodies"]["kv_decode"]
            out[f"{arch}_engine_entry_launches"] = d["bodies"]["kv_decode_entry"]
        labels = ("danube", "gemma3", "internlm2")
    else:
        out["whisper_launches"] = family["whisper"]["serve"]["launches"][name]
        out["vlm_launches"] = family["vlm"]["launches"][name]
        for arch, d in dense.items():
            out[f"{arch}_engine_launches"] = d["launches"][name]
        labels = ("vlm_mlp",) if name == "qgemv" else ("whisper_enc", "vlm_xkv")
    for label in labels:
        row = family["kernels"]["rows"][label]
        out.update({f"{label}_{k}": row.get(k) for k in
                    ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "body")})
        out[f"{label}_shape"] = (f"B={row['B']} H={row['H']} K={row['K']} hd={row['hd']} "
                                 f"S={row['S']} in pages of {row['page_size']}"
                                 if name == "kv_decode" else
                                 f"M={row['M']} K={row['K']} N={row['N']} W{row['bits']}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phase", choices=sorted(SUB_PHASES), default=None,
                    help="run only this phase, which the whole run starts in a "
                         "process of its own (the kernels already built)")
    ap.add_argument("--phase-out", default=None,
                    help="with --phase: pickle the phase's result to this file")
    args = ap.parse_args(argv)

    # cuBLAS's deterministic workspace, read when CUDA starts: the train
    # phase runs with deterministic algorithms, and a resumed run must equal
    # an unbroken one bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's package is missing: {SRC / 'repro_torch'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.deploy import pack
    from repro_torch.kernels.fakequant import kernel as fq_kernel
    from repro_torch.kernels.fakequant import ref as fq_ref
    from repro_torch.kernels.kvattn import kernel as kv_kernel
    from repro_torch.kernels.kvattn import ref as kv_ref
    from repro_torch.kernels.qmatmul import kernel, ops, ref
    from repro_torch.launch import serve

    if args.phase:
        import pickle

        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{args.phase}_") as tmp:
            res = _plain(SUB_PHASES[args.phase](torch, Path(tmp)))
        Path(args.phase_out).write_bytes(pickle.dumps(res))
        return

    t_start = time.perf_counter()
    laps: dict = {}  # phase -> seconds, printed as each ends

    def lap(name: str) -> None:
        laps[name] = time.perf_counter() - t_start - sum(laps.values())
        print(f"[wall] {name} {laps[name]:.1f}s", flush=True)

    kernels = {"qmatmul": kernel, "kvattn": kv_kernel}  # the serving paths'
    build = phase_build({**kernels, "fakequant": fq_kernel})
    lap("build")
    errs, rows = phase_parity(torch, kernel, ref, pack)
    lap("parity")
    kv_err, kv_timed = phase_kv(torch, kv_kernel, kv_ref)
    lap("kv")
    host = phase_host(torch, ops, pack)
    lap("host")
    moe_err, moe_rows = phase_moe_kernel(torch, kernel, ref, pack)
    lap("moe_kernel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _, served = phase_serve(torch, kernel, ops, serve, Path(tmp))
        lap("serve")
        (launches, bodies), engine = phase_engine(torch, serve, kernels, Path(tmp))
        lap("engine")
        moe = phase_moe_serve(torch, serve, kernels, Path(tmp))
        lap("moe")
        audit = phase_audit(torch, {**kernels, "fakequant": fq_kernel})
        lap("audit")
        fq_err, fq_rows = phase_fq_kernel(torch, fq_kernel, fq_ref)
        lap("fq_kernel")
        trained, train_rec = phase_train(torch, Path(tmp))
        lap("train")
        reuse, calib = phase_calib(torch, fq_kernel, fq_ref, kernel, serve, trained,
                                   Path(tmp))
        lap("calib")
        baselines = phase_baselines(torch, fq_kernel, reuse)
        lap("baselines")
        del trained
        mixed = phase_mixed(torch, fq_kernel, fq_ref, kernel, serve, reuse, Path(tmp))
        lap("mixed")
        del reuse
        deploy = phase_deploy(torch, kernels, Path(tmp))
        lap("deploy")
        # the gloo probe's processes start beside calib_moe (light on the
        # card, which calib_moe keeps busy); the ranks, the dry runs and two
        # phases in processes of their own (engine_long; xlstm and hymba)
        # run beside whisper and dense. None of these times a kernel: their
        # own throughputs are taken beside one another
        dist_run, subs = dist_start(), {}
        try:
            calib_moe = phase_calib_moe(torch, fq_kernel, fq_ref, kernel, serve,
                                        Path(tmp))
            lap("calib_moe")
            fq_experts = _time_fq_experts(torch, fq_kernel, fq_ref)
            lap("fq_experts")
            family = {"kernels": phase_family_kernels(torch, kernel, ref, pack, kv_kernel,
                                                      kv_ref)}
            lap("family_kernels")
            recurrent = {"kernels": phase_recurrent_kernels(torch, kernel, ref, pack,
                                                            fq_kernel, fq_ref)}
            lap("recurrent_kernels")
            family["vlm"] = phase_vlm(torch, kernel, serve, Path(tmp))  # 47 GB at peak
            lap("vlm")
            torch.cuda.empty_cache()  # the card's memory, for the processes
            dist_go(dist_run, Path(tmp))
            subs = {name: sub_start(name, Path(tmp)) for name in SUB_PHASES}
            subs["quickstart"] = quickstart_start(Path(tmp))
            family["whisper"] = phase_whisper(torch, fq_kernel, fq_ref, kernel, serve,
                                              Path(tmp))
            torch.cuda.empty_cache()
            lap("whisper")
            family["dense"] = phase_dense_cfgs(torch, serve, kernels)
            torch.cuda.empty_cache()
            lap("dense")
            long_engine = sub_result(subs["engine_long"])
            lap("engine_long")
            recurrent.update(sub_result(subs["recurrent"]))
            lap("recurrent")
            quickstart = quickstart_result(subs["quickstart"])
            lap("quickstart")
            dist = phase_dist(torch, kernel, ref, pack, dist_run)
            lap("dist")
        finally:
            dist_stop(dist_run)
            for sub in subs.values():
                if sub["proc"].poll() is None:
                    sub["proc"].kill()
                    sub["proc"].wait()

    line = kernel_line(errs, rows, kv_err, kv_timed, launches, bodies,
                       {"err": moe_err, "rows": moe_rows,
                        "launches": moe["fixed"]["launches"],
                        "bodies": moe["fixed"]["bodies"]},
                       {"err": fq_err, "rows": fq_rows, "launches": calib["launches"],
                        "experts": fq_experts},
                       long_engine, calib_moe, mixed, family, recurrent, calib["w4"],
                       deploy, dist)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": device, "nvidia_smi": smi, "build": build,
             "timings": rows, "kv_timings": kv_timed, "host": host,
             "serve": served, "engine": engine, "engine_long": long_engine,
             "moe_timings": moe_rows,
             "moe": moe, "fakequant_timings": fq_rows, "calib": calib,
             "train": train_rec, "baselines": baselines, "mixed": mixed,
             "calib_moe": calib_moe,
             "fakequant_experts": fq_experts, "deploy": deploy,
             "family": family, "recurrent": recurrent, "dist": dist,
             "audit": audit, "quickstart": quickstart,
             "kernels": line["kernels"], "phase_s": laps,
             "wall_s": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"[wall] wall_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
