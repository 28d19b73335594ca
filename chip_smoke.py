#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepearth_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device and build: requires CUDA, prints the card, builds the kernels;
  2. K2-fwd (hash_encode_fwd) against its plain PyTorch version on the card;
  3. K1-fwd (pairwise_attention_fwd) against its plain PyTorch version, by
     both its routes (as K1-bwd's in phase 5: 8 lanes a (row, head) on
     16-byte register loads, or a warp a (row, head)), at phase 5's cases;
     the route and launches per case, all-masked rows exactly 0, two runs
     bitwise equal; times of both routes, the plain version, the library
     and the bound at the A-stack shape;
  4. the serving slice: DeepEarthModel at the A-stack configuration (hidden
     768, 12 heads, 12 fusion layers, Grid4D 16 levels on 2^19 tables + 8 on
     2^17, species vocab 232, bf16 compute) answers requests of 1, 37 and
     4096 observations; every forward must launch K2-fwd twice and K1-fwd 16
     times (all on its streaming route), and its outputs must agree with the
     same model run through the plain versions;
  5. K1-bwd (pairwise_attention_bwd) against its plain PyTorch version, by
     both its routes (bf16 on its grid, at most 3 tokens a side: 8 lanes a
     (row, head) on 16-byte register loads; fp32, a head dim off the
     8-element grid or more tokens: a warp a (row, head)), at the A-stack
     shape, the fused qkv views, a key mask with all-masked rows (exactly
     0), B=1000, Nq 2 / Nk 5, Dh 160 and, in bf16, Dh 36 and Nq 2 / Nk 3
     with a key mask; the route and launches per case, two runs bitwise
     equal; times of both
     routes, the plain version, the library and the bound at the A-stack
     shape;
  6. K2-bwd (hash_encode_bwd) against its plain PyTorch version, by both
     its routes (F = 2: the dense gradient written whole, zeroing then a
     float2 scatter; else scalar atomics into torch.zeros), a case whose
     output memory holds NaN before the call; the route and launches per
     case, the run-to-run difference; times of both routes, the plain
     version and the bound at the A-stack's tables;
  7. the training slice: the same model trained at B=4096 with masking
     through Trainer.fit and Trainer.evaluate; every train step must launch
     K2-fwd 2, K2-bwd 2 (dense), K1-fwd 16 and K1-bwd 16 times (both on
     their streaming routes, none on the warp or scalar routes); 3 steps
     with the kernels must agree with 3 steps through the plain versions
     from the same state; the loss must fall over 30 steps on one repeated
     batch;
  8. K3-fwd (vmem_attention_fwd) against its plain PyTorch version, in bf16
     and fp32, at the multimodal slice's two sites (B=512), ragged masked
     cases with an all-masked row (exactly 0), Nk = 1024, and head dims off
     the 8-element grid (the mma.sync route; the other bf16 cases its TMA
     route); the route and launches per case, two runs bitwise equal;
     times of the TMA and mma.sync routes, the library, the bound and the
     TMA route's own floor at the two sites and at the flagship's MLA site
     (B=64, 576 x 576, 128 / 128);
  9. the multimodal serving slice: DeepEarthModel at the configuration of
     tools/bench_multimodal.py (universal dim 512, 8 heads, 4 fusion layers,
     species + vision (576 V-JEPA2 patches of 1408) + language (7168), bf16)
     answers requests of 1, 32 and 512 observations; every forward must
     launch K3-fwd 2 (on its TMA route), K2-fwd 2 and K1-fwd 0 times and
     never reach a plain version, and its outputs must agree with the plain
     path's;
 10. K3-bwd (vmem_attention_bwd) against its plain PyTorch version, in bf16
     and fp32, at the same cases as phase 8 (v a strided view at the MLA
     sites) and head dims off the 8-element grid (the mma.sync route; the
     other bf16 cases its TMA route); all-masked rows get no gradient; the
     route and launches per case, two runs bitwise equal; times of the TMA
     and mma.sync routes, the library and the bound at the two B=512 sites
     and the flagship's MLA site;
 11. K4-fwd and K4-bwd (flash_attention_fwd/bwd) against their plain
     versions, in bf16 and fp32: the vision MLA over a V-JEPA2 clip (8
     heads, 4608 patches, Dqk 48, Dv 32, v strided), causal, key-masked
     with an all-masked row (output exactly 0), 128-wide heads, head dims
     off the 8-element grid (the mma.sync routes; the others the TMA
     routes); the routes and launches per case, two runs of each kernel
     bitwise equal; times of both kernels' TMA and mma.sync routes, the
     library and the bound (the forward's beside its exp units' floor) at
     Dqk 48 / Dv 32 (B=8, 64) and 128 / 128 (B=8, 32; the forward also at
     B=64);
 12. the multimodal train slice at 576 patches: Trainer.fit at B=512 with
     masking and the bench script's contrastive weight; every step must
     launch K3-fwd 2, K3-bwd 2 (both on their TMA routes), K2-fwd 2, K2-bwd
     2 and nothing else, and reach no plain version; 3 steps against the plain
     path, the loss must
     fall on one repeated batch; step time, peak memory, per-op profile;
 13. the multimodal model at 4608 patches per observation: requests of 1
     and 16 (K4-fwd 1 on its TMA route, K2-fwd 2 per forward) and
     Trainer.fit at B=64 (K4-fwd 1 and K4-bwd 1 on their TMA routes, K2-fwd
     2, K2-bwd 2 per step), no plain version reached;
     forward and 3 train steps against the plain path at B=8 (the loss
     within CLIP_TRAIN_TOL); times;
 14. K5-fwd (grouped_matmul_fwd) and K5-bwd (grouped_matmul_split_dout,
     grouped_matmul_bwd_dlhs and grouped_matmul_bwd_drhs) against their
     plain PyTorch versions, in bf16 and fp32: the flagship simulator's
     shape at B=64 (2816 sorted rows, 8 experts, 2048 x 2048), empty
     groups, tiles that cross groups, groups of 1-3 rows, K = N = 8, M = 1,
     K and N off the 8-element grid (the mma.sync routes; the others the
     TMA routes), rows past the last group, an fp32 dout with genuine low
     bits; the split bitwise, two runs bitwise equal, launches per route;
     times, bounds, the mma.sync routes' kernels and library grouped
     matmuls at the flagship shape;
 15. the flagship's serving slice: DeepEarthModel at
     integrated_config(use_deepseek_fusion=True) (5.04B parameters, bf16,
     24 fusion layers, a 24-layer MLA + MoE simulator, vision (B, 4608,
     1408) and language (B, 16, 7168) through MoE-projected encoders)
     answers requests of 1, 16 and 64 observations; per forward K4-fwd 2
     (on its TMA route), K2-fwd 2 and, at B=64 where the simulator takes
     the ragged path, K5
     69 on its TMA route (none at B <= 16), no plain version reached; its
     draw from a generator of its own seeded from SEED; each MoE site's
     dispatch mode, times, peak memory, a per-op profile at B=64; the
     simulator alone at B=64 and the whole model at B=8 (simulator forced
     ragged) against the plain path, holding the observations whose
     routing no near-tie flipped;
 16. the flagship's train step: Trainer.fit on the same model with 576
     V-JEPA2 patches per observation at B=64 (the train plan's batch), the
     bench script's optimizer (bf16 first moment, factored second moment)
     and LossWeights(contrastive=0, moe_aux=0.01), masking on; every step
     must launch K5-fwd 69 and K5-bwd's split 69 and dlhs + drhs 69 + 69,
     all on their TMA routes, K3-fwd 2, K3-bwd 2 (both on their TMA
     routes), K2-fwd 2, K2-bwd 2 and nothing else, and reach no plain
     version; its draw from a generator
     of its own seeded from SEED; each MoE site's
     dispatch mode; 3 steps against the plain path from one start state
     kept on the host, routing pinned as in phase 15; step time, peak
     memory, a per-op profile with K5's share of the step;
 17. K6 (int8_bmm) and K7 (int4_bmm), each by both its routes (tensor
     cores in one cluster launch, CUDA cores), against their plain versions,
     x in bf16 and fp32, at the decode path's shapes (dense E=1 at C 1, 5,
     8, 32 for q_proj 2048 -> 3072 and kv_a_proj_with_mqa 2048 -> 576;
     experts E=16 at C 4, 16, 32, 128 for 2048 -> 1024 and 1024 -> 2048);
     the decode shapes on the tensor-core routes; two runs of each route
     bitwise equal; times of both routes with the weights out of L2,
     bounds,
     torch._weight_int8pack_mm (K6) and torch._weight_int4pack_mm (K7, on
     a one-time uint4 repack) where this torch has them on the card; one B=8
     decode step's 177 products timed;
 18. decode at tools/bench_decode.py's config (2.424B parameters, bf16,
     tied embeddings): bf16, int8 and int4 trees (the int8 / int4 ones by
     quantize_decoder_params, their bytes BENCH_DECODE.json's), greedy
     generate of 256 tokens after a 64-token prompt at B=1, 8, 32 over a
     bf16 cache; per call K6 319 x 177 = 56,463 times (int8), K7 as many
     (int4), each all on its tensor-core route, neither at bf16, no plain
     version reached; wall time, tokens/s, ms per step, peak memory, a
     per-op profile of one int8 step at B=8 with K6's device time in it;
     kernel vs plain at B=8: the prompt's logits teacher-forced with
     routing pinned, flips counted, and the greedy tokens' agreement;
then a JSON line of the kernels, the card's name and power limit, and
{"ok": true, ...} as the last line. Any failure raises and exits non-zero.
Weights are random, drawn from a seeded generator on the card.

    python3 chip_smoke.py --clip-batch-search

runs only the flagship's train step at 4608 patches per observation and
prints the largest batch that fits, without the last two lines.

    python3 chip_smoke.py --flagship-train-spread 1 2 3 4 5 6

runs only phase 16's kernel-vs-plain comparison, once per seed (seed 0 is
phase 16's own draw), and beside it plain against plain with K5's plain
version summing K in two halves, and prints each seed's per-step
differences, without the last two lines.

    python3 chip_smoke.py --mm-train-spread 0 1 2 3 4 5 6

runs only phases 12's and 13's kernel-vs-plain train comparisons (576
patches at B=512, 4608 at B=8), once per seed (the weights and batches drawn
from it), and beside each plain against plain with K3's or K4's plain
version summing P.V in two halves, and prints each seed's differences,
without the last two lines.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import time
from typing import Optional
from unittest import mock

import torch
import torch.nn.functional as F

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import (
    DeepEarthConfig,
    DeepSeekBlockConfig,
    Grid4DConfig,
    MLAConfig,
    ModalityConfig,
    MoEConfig,
    TransformerConfig,
    integrated_config,
)
from deepearth_tpu_torch.models import (
    DeepEarthModel,
    DeepSeekForCausalLM,
    MoELayer,
    cache_bytes_per_token,
    causal_lm_decode_step,
    full_cache_bytes_per_token,
    fusion,
    generate,
    init_cache,
)
from deepearth_tpu_torch.models.deepseek import capacity
from deepearth_tpu_torch.ops import (
    attention_smallseq,
    attention_vmem,
    flash_attention,
    grouped_matmul,
    hash_encoding,
    moe,
    quant,
)
from deepearth_tpu_torch.training import (
    LossWeights,
    Trainer,
    TrainState,
    create_optimizer,
)

SEED = 0
HASH_TOL = 1e-6  # same fp32 operations in the same order: expect 0
ATTN_TOL = {torch.float32: 1e-5,  # fp32 sums in another order
            torch.bfloat16: 2e-2}  # one bf16 ulp at |x| < 4 (2^-6)
# bf16 through 12 layers (see PERF.md for measured values): kernel and plain
# sums round differently, a bf16 output flips by an ulp now and then, and the
# residual stream carries each difference on. A request of one observation
# sees its differences in every output, so its mean is the largest.
SLICE_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
REQUEST_SIZES = (1, 37, 4096)
K2_PER_FORWARD, K1_PER_FORWARD = 2, 16
# K1-bwd: elementwise |kernel - plain| <= rtol |plain| + atol. Both sum the
# same fp32 products in another order (~1e-6 here) and round once to the
# input type: in bf16 that may land one ulp apart, 2^-7 of the value.
ATTN_BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-4)}
# K2-bwd: atomics add a row's terms in another order than index_add_, so
# |kernel - plain| <= HASH_BWD_TOL * sum |terms| of the row (an fp32 sum of
# k terms in two orders differs by ~sqrt(k) 2^-24 of it; k <= ~1600 here).
HASH_BWD_TOL = 1e-5
TRAIN_BATCH, TRAIN_STEPS, LOSS_FALL_STEPS = 4096, 3, 30
# Kernel vs plain train path over TRAIN_STEPS steps from one state, bf16
# compute: the loss (a mean over 4096 observations) and the grad norm agree
# to TRAIN_TOL relative. Params: Adam moves each by at most ~lr per step and
# a gradient at rounding-noise level can flip its sign, so they agree to
# 3 * sum(lr) absolute (the default warmup gives lr 0, 1e-6, 2e-6).
TRAIN_TOL = {"loss": 2e-3, "grad_norm": 2e-2}
# K3-fwd: fp32 sums in another order; in bf16 the output rounds once, one
# ulp at |x| < 4 (2^-6), and a probability may round to the other bf16
# neighbour when exp differs in its last fp32 bit.
VMEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MM_BATCH, MM_REQUEST_SIZES, VISION_PATCHES = 512, (1, 32, 512), 576
# the objective tools/bench_multimodal.py trains
MM_LOSS_WEIGHTS = LossWeights(contrastive=0.1)
# launches per train step of the multimodal model at 576 patches: the vision
# encoder's MLA and cross-attention (K3), the Grid4D tables (K2)
MM_PER_STEP = {"vmem_attention_fwd": 2, "vmem_attention_bwd": 2,
               "hash_encode_fwd": 2, "hash_encode_bwd": 2}
# K3-bwd and K4-bwd: fp32 sums in another order, exp on the MUFU unit; in
# bf16 a rounded p or ds may land on the other neighbour. Each gradient
# within BWD_TOL of its largest entry (two bf16 ulps of it), plus 1e-6 for a
# gradient that is 0 up to rounding.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# K4-fwd rounds each key tile's unnormalised p (the library's online
# softmax), its plain version the normalised p of the full row; both round
# the output once. The largest |kernel - plain| is within VMEM_TOL in fp32,
# and in bf16 within two ulps of the plain output's largest entry (2^-6 of
# it) plus 1e-6. The mean is within 2^-8 of the mean |plain|: at the
# 4608-patch MLA the softmax spreads over ~N/e keys, so one key tile's P.V
# left out (1/72 of the keys) would move it by ~12%. The log-sum-exp agrees
# to K4_LSE_TOL absolute.
K4_MAX_REL, K4_MEAN_REL, K4_LSE_TOL = 2 ** -6, 2 ** -8, 1e-4
# a V-JEPA2 clip: 8 frames of 576 patches; the train step's batch, the
# request sizes, and the batch where the plain path's (B, 8, 4608, 4608)
# fp32 scores fit with what autograd saves of them (~2 GB per observation)
CLIP_PATCHES, CLIP_BATCH, CLIP_REQUEST_SIZES = 4608, 64, (1, 16)
CLIP_PLAIN_BATCH = 8
# the cross-attention over 4608 keys takes the plain path, as in JAX
CLIP_PER_FORWARD = {"flash_attention_fwd": 1, "hash_encode_fwd": 2}
CLIP_PER_STEP = {"flash_attention_fwd": 1, "flash_attention_bwd": 1,
                 "hash_encode_fwd": 2, "hash_encode_bwd": 2}
K3_PER_FORWARD = 2
# bf16 through the vision encoder (one MLA layer over 576 patches), the
# token cross-attention and 4 fusion layers: kernel and plain round
# differently, and the residual streams carry each difference on.
MM_SLICE_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
# K5 returns fp32 in both types, and kernel and plain version differ only in
# the order of their fp32 sums; held as K4 is: in bf16 the largest error
# within K4_MAX_REL of the plain output's largest entry and the mean error
# within K4_MEAN_REL of the mean |plain| (a k-tile of 32 left out of 2048
# would move it by ~12%); in fp32 within K5_FP32_REL of the largest entry.
K5_FP32_REL = 1e-5
# the flagship: bench_flagship.py's request of 16 observations, one and the
# train plan's 64; each observation a V-JEPA2 clip and 16 language rows
FLAGSHIP_REQUEST_SIZES, FLAGSHIP_PLAIN_BATCH = (1, 16, 64), 8
FLAGSHIP_TOKENS = 22  # CLS, spacetime, 16 vision, 4 language
# 23 MoE layers in the simulator (layer 0 is dense), 3 K5 launches each when
# it takes the ragged path: at B=64 (1408 tokens, S E C > 2^22), not at
# B <= 16, where capacity dispatch's one-hot einsums are small
K5_PER_RAGGED_FORWARD = 69
K5_PER_FORWARD = {1: 0, 16: 0, 64: K5_PER_RAGGED_FORWARD}
FLAGSHIP_PER_FORWARD = {"flash_attention_fwd": 2, "hash_encode_fwd": 2}
# kernel vs plain path of the flagship with the plain run routed as the
# kernel run was (bf16 through 24 fusion and 24 simulator layers): read max
# 0.125 and mean 0.0103 (the simulator alone at B=64) and 0.0118 (the whole
# model at B=8) on an H100 (PERF.md), held at about twice that. The share of
# tokens whose own routing would flip at an MoE site read at most 0.0156
# (the simulator alone) and 0.0511 (a late simulator layer of the whole
# model); held at 0.1: routing on unrelated inputs would flip most tokens.
FLAGSHIP_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
FLAGSHIP_MAX_FLIPPED = 0.1
# K5-bwd sums in fp32 with dout kept at fp32 accuracy and rounds once, as
# its plain version does: held as K5-fwd is, and in bf16 at least this share
# of the entries must equal the plain version's (a kernel that rounded dout
# to bf16 first would match about 58%)
K5_BWD_MIN_EQUAL = 0.99
# the flagship's train step: tools/bench_flagship.py's objective (no
# contrastive term) plus the MoE aux term, at the train plan's batch with
# 576 patches per observation; launches per step: the simulator's 23 MoE
# layers through K5 (3 products each, forward and both gradients; the
# gradients by the TMA route, one split of dout each), the
# vision encoder's two MLA layers over 576 patches through K3 (its
# cross-attention, 8 heads of 256, is past K3's 128 and runs the plain
# path, as in JAX), the Grid4D tables through K2
FLAGSHIP_TRAIN_WEIGHTS = LossWeights(contrastive=0.0, moe_aux=0.01)
FLAGSHIP_TRAIN_BATCH = 64
FLAGSHIP_PER_STEP = {
    "grouped_matmul_fwd": K5_PER_RAGGED_FORWARD,
    "grouped_matmul_split_dout": K5_PER_RAGGED_FORWARD,
    "grouped_matmul_bwd_dlhs": K5_PER_RAGGED_FORWARD,
    "grouped_matmul_bwd_drhs": K5_PER_RAGGED_FORWARD,
    "vmem_attention_fwd": 2, "vmem_attention_bwd": 2,
    "hash_encode_fwd": 2, "hash_encode_bwd": 2}
# kernel vs plain train path of the flagship over TRAIN_STEPS steps, routing
# pinned, the configured schedule (lr 0, 1e-6, 2e-6, as phase 7 compares):
# per step relative differences of the loss, the aux term and the grad norm;
# the parameters as in phase 7, beyond one bf16 ulp of each. One tree reads
# the same bits on every run; the reading moves with the draw, which this
# phase takes from a generator of its own seeded from SEED
# (flagship_generator), so that what the earlier phases draw does not move
# it. The model itself carries one change of summation order this far:
# plain against plain with K5's plain version summing K in two halves
# (--flagship-train-spread 0 1 2 3 4 5 6, seed 0 this phase's own draw)
# read at most 1.47e-3 on the loss (seed 0), 2.42e-5 on the aux term and
# 8.63e-3 on the grad norm on an H100 (PERF.md). The loss's reading
# alone passes 1.2e-3, the limit one earlier draw set, so the loss limit is
# TRAIN_TOL_FACTOR times it ("about twice", as this file's other limits);
# the aux and grad norm limits stay as set (3e-5, 1.5e-2), above their
# plain-vs-plain readings. A constant lr of 1e-4 instead moves every element
# by ~lr at once, as the sign of its gradient says, and where that sign is
# rounding noise the two runs part: 75.5% of one site's tokens routed apart
# by step 3.
PLAIN_VS_PLAIN_LOSS, TRAIN_TOL_FACTOR = 1.47e-3, 2
FLAGSHIP_TRAIN_TOL = {"loss": TRAIN_TOL_FACTOR * PLAIN_VS_PLAIN_LOSS,
                      "moe_aux": 3e-5, "grad_norm": 1.5e-2}
# phase 13's train comparison (4608 patches, B=8, 3 steps): plain against
# plain with K4's plain version summing P.V in two halves
# (--mm-train-spread 0 1 2 3 4 5 6) read up to 2.32e-3 on the loss (seed 0)
# and 4.21e-3 on the grad norm on an H100 (PERF.md): above TRAIN_TOL's loss
# limit, so the model itself carries one change of summation order past it
# over 4608 patches. Phase 13's loss limit is TRAIN_TOL_FACTOR times that
# reading, as phase 16's; its grad norm limit stays TRAIN_TOL's. Phases 7
# and 12 keep TRAIN_TOL (at 576 patches plain against plain read at most
# 2.02e-4 on the loss).
PLAIN_VS_PLAIN_CLIP_LOSS = 2.32e-3
CLIP_TRAIN_TOL = {"loss": TRAIN_TOL_FACTOR * PLAIN_VS_PLAIN_CLIP_LOSS,
                  "grad_norm": TRAIN_TOL["grad_norm"]}
# the batches tried for the train step at 4608 patches, largest first
CLIP_SEARCH_BATCHES = (64, 48, 32, 24, 16, 12, 8, 4, 2, 1)
# K6 / K7 against their plain versions (phase 17): (E, C, D, F) of the decode
# path at tools/bench_decode.py's widths. Dense projections reach them at
# E=1 with C the batch: q_proj 2048 -> 3072, kv_a_proj_with_mqa 2048 -> 576
# (Fp 640); the experts at E=16, 2048 -> 1024 and 1024 -> 2048. With the
# config's capacity_factor 2.0 an expert gets max(4, ceil(B / 2)) slots (4
# at B <= 8, 16 at B=32); 32 and 128 are the drop-free slots of B=8 and 32.
QUANT_CASES = {
    "q_proj C1": (1, 1, 2048, 3072), "q_proj C5": (1, 5, 2048, 3072),
    "q_proj C8": (1, 8, 2048, 3072), "q_proj C32": (1, 32, 2048, 3072),
    "kv_a C1": (1, 1, 2048, 576), "kv_a C8": (1, 8, 2048, 576),
    "kv_a C32": (1, 32, 2048, 576),
    "experts up C4": (16, 4, 2048, 1024), "experts up C16": (16, 16, 2048, 1024),
    "experts up C32": (16, 32, 2048, 1024),
    "experts up C128": (16, 128, 2048, 1024),
    "experts down C4": (16, 4, 1024, 2048),
    "experts down C32": (16, 32, 1024, 2048),
    "experts down C128": (16, 128, 1024, 2048),
}
# the kernels line's numbers: one dense decode projection at B=8
QUANT_LINE_CASE = "q_proj C8"
# K6 / K7 against their plain versions: fp32 outputs within 1e-5 of the
# largest entry (fp32 sums in another order; every product is exact); bf16
# outputs within one bf16 ulp of the largest entry (the same sums, rounded
# once: a value near a rounding boundary may land on the other neighbour)
QUANT_FP32_REL = 1e-5
# decode at tools/bench_decode.py's config (phase 18): prefill 64 + 256 new
# tokens, bf16 parameters and cache, greedy, tied embeddings
DECODE_VOCAB, DECODE_PROMPT, DECODE_NEW = 32000, 64, 256
DECODE_BATCHES = (1, 8, 32)
DECODE_STEPS = DECODE_PROMPT + DECODE_NEW - 1
# K6 (int8) or K7 (int4) calls per decode step, as tools/bench_decode.py's
# config should give them (decode_products counts them from the tree): 3 MLA
# projections x 20 layers, layer 0's 3 SwiGLU projections, 6 per MoE layer
# x 19 (the shared expert's 3, the experts' 3); kv_b_proj is absorbed and
# the tied LM head is the embedding, neither quantized
QUANT_PER_STEP = 3 * 20 + 3 + 6 * 19
# kernel vs plain decode at B=8, the prompt's logits teacher-forced with
# routing pinned (bf16 through 20 layers: a K6 / K7 output near a rounding
# boundary lands on the other neighbour, and the residual stream carries it
# on): the largest difference in bf16 ulps of the largest logit, the mean
# over the mean |plain|, and the share of (token, MoE layer) choices whose
# own routing would flip. Readings of the kernels as they stand on an H100
# (PERF.md): 2.75 and 2.50 ulps, 0.0161 and 0.0149, 0.0325 and 0.0271
# (int8, int4); held at about twice that. The greedy tokens are reported, not held: a random
# model's logits are near-ties, and one flip parts a row for the rest of it.
DECODE_TOL = {"max_over_ulp": 6.0, "mean_rel": 0.035, "flipped": 0.07}
# BENCH_DECODE.json's weight bytes of the three trees
BENCH_DECODE_BYTES = {"bf16": 4_849_386_688, "int8": 2_542_049_472,
                      "int4": 1_382_848_704}

# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s of HBM and
# operations/s by type; fp32 without the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(bytes_moved: float, flops: float, dtype) -> dict:
    """The least time the card needs: the larger of moving the bytes at the
    HBM rate and doing the operations at the type's peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def expected_launches(**counts) -> dict:
    """Every kernel's launch count: 0 except those given."""
    return {name: counts.get(name, 0) for name in kernels.launch_counts}


def route_counts(launches: dict, *names: str) -> str:
    """The launches of each route of the kernels ``names``: the TMA route
    under the kernel's own counter, the others under _mma and _fp32."""
    return "; ".join(
        f"{name}: TMA {launches[name]}, mma.sync {launches[name + '_mma']}, "
        f"fp32 {launches[name + '_fp32']}" for name in names)


def astack_config() -> DeepEarthConfig:
    """The configuration of bench.build_astack, with bf16 compute."""
    cfg = DeepEarthConfig(
        hidden_dim=768, n_heads=12, n_layers=12,
        grid4d=Grid4DConfig(n_spatial_levels=16, n_temporal_levels=8,
                            n_features_per_level=2, hash_table_size=2 ** 19),
        modality_encoder=TransformerConfig(hidden_dim=384, n_heads=6,
                                           n_layers=4),
        compute_dtype=torch.bfloat16,
    )
    cfg.add_modality(ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=232))
    return cfg


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 16) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so that the host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=20, warmup=2) / reps


def tags(by_dtype: dict) -> dict:
    """A {dtype: value} table keyed by the dtypes' short names."""
    return {str(k).split(".")[-1]: v for k, v in by_dtype.items()}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


@contextlib.contextmanager
def plain_versions():
    """Route every kernel site to its plain PyTorch version; in training,
    autograd through those plain forwards gives the plain backward."""
    with mock.patch.object(hash_encoding, "hash_encode",
                           hash_encoding.hash_encode_plain), \
         mock.patch.object(fusion, "pairwise_token_attention",
                           attention_smallseq.pairwise_token_attention_plain), \
         mock.patch.object(attention_vmem, "vmem_attention",
                           attention_vmem.vmem_attention_plain), \
         mock.patch.object(flash_attention, "flash_attention",
                           flash_attention.flash_attention_plain), \
         mock.patch.object(grouped_matmul, "gmm", grouped_matmul.gmm_plain), \
         mock.patch.object(kernels, "int8_bmm", quant.int8_bmm_plain), \
         mock.patch.object(kernels, "int4_bmm", quant.int4_bmm_plain):
        yield


@contextlib.contextmanager
def plain_versions_refused():
    """Make every plain version raise: a run inside reaches none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")
    with mock.patch.object(hash_encoding, "hash_encode_plain", refuse), \
         mock.patch.object(attention_smallseq,
                           "pairwise_token_attention_plain", refuse), \
         mock.patch.object(attention_vmem, "vmem_attention_plain", refuse), \
         mock.patch.object(attention_vmem, "vmem_attention_bwd_plain",
                           refuse), \
         mock.patch.object(flash_attention, "flash_attention_plain", refuse), \
         mock.patch.object(flash_attention, "flash_attention_bwd_plain",
                           refuse), \
         mock.patch.object(grouped_matmul, "gmm_plain", refuse), \
         mock.patch.object(grouped_matmul, "gmm_bwd_plain", refuse), \
         mock.patch.object(grouped_matmul, "split_dout_plain", refuse), \
         mock.patch.object(quant, "int8_bmm_plain", refuse), \
         mock.patch.object(quant, "int4_bmm_plain", refuse):
        yield


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    print(f"[1 device+build] {card()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in {seconds:.2f} s: {lib.name}")
    log = lib.with_name(lib.name + ".log").read_text()
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma")):
            print(f"    ptxas: {line.strip()}")


def _hash_case(gen, n, levels, table, d, f=2, interpolation="linear",
               table_size=None) -> float:
    coords = torch.rand((n, d), generator=gen, device="cuda")
    # exact grid points of every level (multiples of 1/16) and the edges
    coords[: n // 8] = torch.randint(0, 17, (n // 8, d), generator=gen,
                                     device="cuda").float() / 16
    coords[0], coords[1] = 0.0, 1.0
    tables = torch.empty((levels, table, f), device="cuda").uniform_(
        -1e-4, 1e-4, generator=gen)
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device="cuda")
    kw = dict(interpolation=interpolation, table_size=table_size)
    out = hash_encoding.hash_encode(coords, tables, res, **kw)
    ref = hash_encoding.hash_encode_plain(coords, tables, res, **kw)
    if out.shape != (n, levels * f) or ref.shape != out.shape:
        raise AssertionError(f"K2 output shape {tuple(out.shape)}")
    return max_err(out, ref)


def phase_hash(gen) -> dict:
    n = 4096
    cases = {
        "spatial L16 T2^19 D3": dict(levels=16, table=2 ** 19, d=3),
        "temporal L8 T2^17 D1": dict(levels=8, table=2 ** 17, d=1),
        "T=3001 D3": dict(levels=4, table=3001, d=3),
        "nearest D3": dict(levels=16, table=2 ** 19, d=3,
                           interpolation="nearest"),
        "D2 F3": dict(levels=4, table=4096, d=2, f=3),
        "D4 hashed into 1000 of 1024": dict(levels=4, table=1024, d=4,
                                            table_size=1000),
    }
    errs = {name: _hash_case(gen, n, **kw) for name, kw in cases.items()}
    worst = max(errs.values())
    if worst > HASH_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {errs}")

    # time at the slice's shapes over 16 distinct coordinate sets, so that
    # the fine levels' rows are not all in L2 from the previous call
    times = {}
    grid4d = astack_config().grid4d
    for name, hcfg in (("spatial", grid4d.spatial),
                       ("temporal", grid4d.temporal)):
        tables = hash_encoding.init_hash_tables(hcfg, generator=gen,
                                                device="cuda")
        res = torch.tensor(hcfg.resolutions, dtype=torch.float32,
                           device="cuda")
        pool = [torch.rand((n, hcfg.coords_dim), generator=gen, device="cuda")
                for _ in range(16)]
        if name == "spatial":
            k2_bound = bound(hash_fwd_bytes(pool, tables, res, hcfg),
                             2 * n * hcfg.output_dim * 2 ** hcfg.coords_dim,
                             torch.float32)
        for label, fn in (("kernel", hash_encoding.hash_encode),
                          ("plain", hash_encoding.hash_encode_plain)):
            coords = itertools.cycle(pool)
            call = lambda: fn(next(coords), tables, res)  # noqa: E731
            times[f"{name}_{label}"] = graph_ms(call)
            times[f"{name}_{label}_eager"] = cuda_ms(call)
    print(f"[2 K2 hash_encode_fwd] max_abs_err {worst:.3g} (tol {HASH_TOL}) "
          f"over {len(cases)} cases | ms at N=4096 (device; eager with host "
          "launch cost): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" | spatial bound {k2_bound['bound_ms']:.4f} ms "
          f"({k2_bound['bound_by']}) | {card()}")
    return {"max_abs_err": worst, "ms": times["spatial_kernel"],
            "plain_ms": times["spatial_plain"], "library_ms": None,
            **k2_bound}


def hash_fwd_bytes(pool, tables, res, hcfg) -> float:
    """Mean bytes one K2-fwd call over the pool must move: coords and
    resolutions in, the distinct table rows its points touch (each read
    once), the features out."""
    levels, table, feats = tables.shape
    total = 0
    for coords in pool:
        rows = torch.cat([idx.flatten() for idx, _ in hash_encoding._cell_corners(
            coords, res, levels, table, hcfg.hash_table_size,
            hcfg.interpolation)])
        total += (nbytes(coords, res) + rows.unique().numel() * feats * 4
                  + coords.shape[0] * levels * feats * 4)
    return total / len(pool)


def k1_route(q, k, v, n_heads, direction: str) -> str:
    """The counter of the K1 route (``direction`` "fwd" or "bwd") that the
    dispatch takes for q, k, v."""
    rule = getattr(kernels, f"pairwise_{direction}_tma_route")
    name = f"pairwise_attention_{direction}"
    return name if kernels._pairwise_on_grid(rule, q, k, v, n_heads) \
        else name + "_warp"


def k1_inputs(gen, nq, nk, b, d, dtype, fused_qkv=False):
    """q, k, v for a K1 case: strided views of one projection with
    ``fused_qkv``, as the model has."""
    if fused_qkv:
        qkv = torch.randn((nq, b, 3 * d), generator=gen, device="cuda")
        return qkv.to(dtype).chunk(3, dim=-1)
    return (torch.randn((n, b, d), generator=gen, device="cuda").to(dtype)
            for n in (nq, nk, nk))


def phase_attention(gen) -> dict:
    """K1-fwd by both routes: the dispatch (the streaming route on its
    grid) and the warp route's own wrapper, at every case."""
    errs, routes = {}, {}
    launches = collections.Counter()

    def case(name, nq, nk, b, d, h, dtype, mask=None, fused_qkv=False,
             g=gen):
        q, k, v = k1_inputs(g, nq, nk, b, d, dtype, fused_qkv)
        kw = dict(n_heads=h, scale=(d // h) ** -0.5, key_mask=mask)
        ref = attention_smallseq.pairwise_token_attention_plain(q, k, v, **kw)
        route = k1_route(q, k, v, h, "fwd")
        routes[name] = route
        calls = {route: attention_smallseq.pairwise_token_attention}
        calls.setdefault(
            "pairwise_attention_fwd_warp",
            lambda q, k, v, n_heads, scale, key_mask:
                kernels.pairwise_attention_fwd_warp(q, k, v, n_heads, scale,
                                                    key_mask))
        for counter, call in calls.items():
            tag = name + ("" if counter == "pairwise_attention_fwd"
                          else " warp")
            kernels.reset_launch_counts()
            out = call(q, k, v, **kw)
            torch.cuda.synchronize()
            if kernels.launch_counts != expected_launches(**{counter: 1}):
                raise AssertionError(f"K1 {tag}: launches "
                                     f"{kernels.launch_counts}")
            launches[counter] += 1
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"K1 {tag}: {out.shape} {out.dtype}")
            if mask is not None and not bool(
                    (out[:, ~mask.any(dim=1)] == 0).all()):
                raise AssertionError(f"K1 {tag}: all-masked rows are not "
                                     "zero")
            errs[tag] = max_err(out, ref)
            if errs[tag] > ATTN_TOL[dtype]:
                raise AssertionError(f"K1 {tag}: max_abs_err {errs[tag]} > "
                                     f"{ATTN_TOL[dtype]}")
            if not torch.equal(out, call(q, k, v, **kw)):
                raise AssertionError(f"K1 {tag}: two runs differ")

    b = 4096
    mask = torch.rand((b, 3), generator=gen, device="cuda") > 0.4
    mask[:64] = False  # some rows see no key at all
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        case(f"A-stack {tag}", 3, 3, b, 768, 12, dtype)
        case(f"A-stack fused qkv {tag}", 3, 3, b, 768, 12, dtype,
             fused_qkv=True)
        case(f"key mask {tag}", 3, 3, b, 768, 12, dtype, mask=mask)
        case(f"B=1000 {tag}", 3, 3, 1000, 768, 12, dtype)
        case(f"Nq2 Nk5 {tag}", 2, 5, 1000, 768, 12, dtype)
        case(f"Dh=160 {tag}", 3, 3, 1000, 640, 4, dtype)
    # a head dim off the 8-element grid: the warp route in bf16; Nq != Nk
    # within the streaming route's 3 tokens a side, with a key mask. Drawn
    # from a generator of their own, so that the later phases' draws stay
    # as they were before these cases came
    extra = torch.Generator(device="cuda").manual_seed(SEED)
    case("Dh=36 bfloat16", 3, 3, 1000, 432, 12, torch.bfloat16, g=extra)
    case("Nq2 Nk3 bfloat16", 2, 3, 1000, 768, 12, torch.bfloat16,
         mask=mask[:1000], g=extra)
    if (routes["A-stack fused qkv bfloat16"] != "pairwise_attention_fwd"
            or routes["Dh=36 bfloat16"] != "pairwise_attention_fwd_warp"):
        raise AssertionError(f"K1 routes {routes}")

    q, k, v = (torch.randn((3, b, 768), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    calls = {
        "kernel": lambda: kernels.pairwise_attention_fwd(q, k, v, 12,
                                                         0.125),
        "warp": lambda: kernels.pairwise_attention_fwd_warp(q, k, v, 12,
                                                            0.125),
        "plain": lambda: attention_smallseq.pairwise_token_attention_plain(
            q, k, v, n_heads=12, scale=0.125)}
    times = {}
    for label in ("kernel", "warp", "plain", "warp", "kernel"):
        times.setdefault(label, []).append(graph_ms(calls[label]))
    for label, call in calls.items():
        times[f"{label}_eager"] = [cuda_ms(call)]
    # the library's fused attention on the same values in its own
    # (B, H, N, Dh) layout, timed as a yardstick only
    qh, kh, vh = (bhnd(x, 12) for x in (q, k, v))
    times["library"] = [graph_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=0.125))]
    k1_bound = bound(nbytes(q, k, v, q), 4 * 3 * 3 * b * 768, torch.bfloat16)
    worst = {r: max([e for n, e in errs.items()
                     if n.endswith(" warp") == (r == "warp")], default=0.0)
             for r in ("streaming", "warp")}
    print("[3 K1 pairwise_attention_fwd] routes: bf16 on its grid (at most 3 "
          "tokens a side) 8 lanes a (row, head) on 16-byte register loads "
          "(counted pairwise_attention_fwd), else a warp a (row, head) "
          "(_warp); every case through the dispatch and the warp route | "
          "route per case: " + ", ".join(f"{n} {r}" for n, r in routes.items())
          + f" | launches {dict(launches)} | max_abs_err over {len(routes)} "
          "cases: " + ", ".join(f"{r} {e:.3g}" for r, e in worst.items())
          + " (per case: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; tol {tags(ATTN_TOL)}; all-masked rows exactly 0) | two runs "
          "of each route bitwise equal | ms at (3, 4096, 768) bf16 "
          "(CUDA-graph replays in turns kernel, warp, plain, warp, kernel; "
          "eager with host launch cost; library = "
          "scaled_dot_product_attention): " + ", ".join(
              f"{k} {' '.join(f'{t:.4f}' for t in v)}"
              for k, v in times.items())
          + f" | bound {k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']})"
          f" | {card()}")
    return {"max_abs_err": worst["streaming"],
            "warp_max_abs_err": worst["warp"], "ms": min(times["kernel"]),
            "warp_ms": min(times["warp"]), "plain_ms": times["plain"][0],
            "library_ms": times["library"][0], "launches": dict(launches),
            **k1_bound}


def bhnd(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A token-major (N, B, D) tensor as a contiguous (B, H, N, Dh) one."""
    n, b, d = x.shape
    return x.view(n, b, n_heads, d // n_heads).permute(1, 2, 0, 3).contiguous()


def output_diff(out: dict, ref: dict) -> dict:
    """Max and mean absolute difference over the fused representation and
    every reconstruction."""
    pairs = [(out["fused_representation"], ref["fused_representation"])]
    pairs += [(v, ref["reconstructions"][k])
              for k, v in out["reconstructions"].items()]
    diff = torch.cat([(a.float() - b.float()).abs().flatten()
                      for a, b in pairs])
    return {"max_abs": diff.max().item(), "mean_abs": diff.mean().item()}


def make_batch(gen, n):
    return {
        "xyzt": torch.rand((n, 4), generator=gen, device="cuda"),
        "modalities": {"species": torch.randint(0, 232, (n,), generator=gen,
                                                device="cuda")},
    }


def phase_slice(gen) -> dict:
    cfg = astack_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [make_batch(gen, n) for n in REQUEST_SIZES]

    # the main path: requests through the user's entry points, counted
    kernels.reset_launch_counts()
    outs = []
    with torch.inference_mode():
        for batch in batches:
            before = dict(kernels.launch_counts)
            outs.append(model(batch))
            feats = model.extract_features(batch)
            got = {k: kernels.launch_counts[k] - before[k] for k in before}
            want = expected_launches(hash_encode_fwd=2 * K2_PER_FORWARD,
                            pairwise_attention_fwd=2 * K1_PER_FORWARD)
            if got != want:
                raise AssertionError(f"launches per request {got} != {want}")
            if not torch.equal(feats, outs[-1]["fused_representation"]):
                raise AssertionError("extract_features != forward")
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)

    errs, repeat = {}, {}
    with torch.inference_mode():
        for batch, out in zip(batches, outs):
            n = batch["xyzt"].shape[0]
            rec = out["reconstructions"]
            shapes = {"fused_representation": (n, 768),
                      "all_tokens": (n, 3, 768), "spatial": (n, 3),
                      "temporal": (n, 1), "species": (n, 232)}
            got = {"fused_representation": out["fused_representation"],
                   "all_tokens": out["all_tokens"], **rec}
            for key, shape in shapes.items():
                t = got[key]
                if tuple(t.shape) != shape or not bool(t.isfinite().all()):
                    raise AssertionError(f"B={n} {key}: shape {tuple(t.shape)}"
                                         f" or non-finite values")
            kernels.reset_launch_counts()
            with plain_versions():
                ref = model(batch)
            if any(kernels.launch_counts.values()):
                raise AssertionError("the plain run launched a kernel")
            errs[n] = output_diff(out, ref)
            # the same path again: run-to-run noise of the rest of the model
            repeat[n] = output_diff(out, model(batch))
    for n, e in errs.items():
        if any(e[k] > SLICE_TOL[k] for k in SLICE_TOL):
            raise AssertionError(f"kernel path vs plain path: {errs}")

    timing = {}
    with torch.inference_mode():
        big = batches[-1]
        timing["forward_ms"] = cuda_ms(lambda: model(big), iters=20)
        timing["forward_device_ms"] = graph_ms(lambda: model(big), reps=3)
        with plain_versions():
            timing["forward_plain_ms"] = cuda_ms(lambda: model(big), iters=20)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[4 slice A-stack] {n_params / 1e6:.1f}M params | requests "
          f"{REQUEST_SIZES} finite, launches per forward K2 {K2_PER_FORWARD} "
          f"K1 {K1_PER_FORWARD} | vs plain path "
          + ", ".join(f"B={k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
                      for k, v in errs.items())
          + f" (tol {SLICE_TOL}; kernel path run twice: " + ", ".join(
              f"B={k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
              for k, v in repeat.items())
          + f") | B=4096 forward {timing['forward_ms']:.3f} ms, in a CUDA "
          f"graph {timing['forward_device_ms']:.3f} ms (plain versions "
          f"{timing['forward_plain_ms']:.3f} ms), "
          f"{4096 / timing['forward_ms'] * 1e3:.0f} obs/s | peak mem "
          f"{peak:.2f} GiB | {card()}")
    return {"launches": launches, **timing}


def phase_attention_bwd(gen) -> dict:
    """K1-bwd by both routes: the dispatch (the streaming route on its
    grid) and the warp route's own wrapper, at every case."""
    errs, routes = {}, {}
    launches = collections.Counter()

    def case(name, nq, nk, b, d, h, dtype, mask=None, fused_qkv=False):
        q, k, v = k1_inputs(gen, nq, nk, b, d, dtype, fused_qkv)
        do = torch.randn((nq, b, d), generator=gen, device="cuda").to(dtype)
        scale = (d // h) ** -0.5
        ref = attention_smallseq.pairwise_token_attention_bwd_plain(
            q, k, v, do, n_heads=h, scale=scale, key_mask=mask)
        route = k1_route(q, k, v, h, "bwd")
        routes[name] = route
        calls = {route: kernels.pairwise_attention_bwd}
        calls.setdefault("pairwise_attention_bwd_warp",
                         kernels.pairwise_attention_bwd_warp)
        rtol, atol = ATTN_BWD_TOL[dtype]
        for counter, call in calls.items():
            tag = name + ("" if counter == "pairwise_attention_bwd"
                          else " warp")
            kernels.reset_launch_counts()
            got = call(q, k, v, do, h, scale, mask)
            torch.cuda.synchronize()
            if kernels.launch_counts != expected_launches(**{counter: 1}):
                raise AssertionError(f"K1-bwd {tag}: launches "
                                     f"{kernels.launch_counts}")
            launches[counter] += 1
            for label, a, r in zip(("dq", "dk", "dv"), got, ref):
                if a.shape != r.shape or a.dtype != dtype:
                    raise AssertionError(f"K1-bwd {tag} {label}: {a.shape} "
                                         f"{a.dtype}")
                diff = (a.float() - r.float()).abs()
                if not bool((diff <= rtol * r.float().abs() + atol).all()):
                    raise AssertionError(
                        f"K1-bwd {tag} {label}: max_abs_err "
                        f"{diff.max().item()} beyond {rtol}|x| + {atol}")
                if mask is not None and not bool(
                        (a[:, ~mask.any(dim=1)] == 0).all()):
                    raise AssertionError(f"K1-bwd {tag} {label}: rows with "
                                         "no visible key have gradients")
                errs[f"{tag} {label}"] = diff.max().item()
            again = call(q, k, v, do, h, scale, mask)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"K1-bwd {tag}: two runs differ")

    b = 4096
    mask = torch.rand((b, 3), generator=gen, device="cuda") > 0.4
    mask[:64] = False  # some rows see no key at all
    mask3 = mask[:1000]
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        case(f"A-stack {tag}", 3, 3, b, 768, 12, dtype)
        case(f"A-stack fused qkv {tag}", 3, 3, b, 768, 12, dtype,
             fused_qkv=True)
        case(f"key mask {tag}", 3, 3, b, 768, 12, dtype, mask=mask)
        case(f"B=1000 {tag}", 3, 3, 1000, 768, 12, dtype)
        case(f"Nq2 Nk5 {tag}", 2, 5, 1000, 768, 12, dtype)
        case(f"Dh=160 {tag}", 3, 3, 1000, 640, 4, dtype)
    # a head dim off the 8-element grid: the warp route in bf16; Nq != Nk
    # within the streaming route's 3 tokens a side
    case("Dh=36 bfloat16", 3, 3, 1000, 432, 12, torch.bfloat16)
    case("Nq2 Nk3 bfloat16", 2, 3, 1000, 768, 12, torch.bfloat16, mask=mask3)
    if routes["A-stack fused qkv bfloat16"] != "pairwise_attention_bwd":
        raise AssertionError(f"K1-bwd routes {routes}")

    q, k, v, do = (torch.randn((3, b, 768), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    plain = attention_smallseq.pairwise_token_attention_bwd_plain
    calls = {
        "kernel": lambda: kernels.pairwise_attention_bwd(q, k, v, do, 12,
                                                         0.125),
        "warp": lambda: kernels.pairwise_attention_bwd_warp(q, k, v, do, 12,
                                                            0.125),
        "plain": lambda: plain(q, k, v, do, n_heads=12, scale=0.125)}
    times = {}
    for label in ("kernel", "warp", "plain", "warp", "kernel"):
        times.setdefault(label, []).append(graph_ms(calls[label]))
    for label, call in calls.items():
        times[f"{label}_eager"] = [cuda_ms(call)]
    # the library's attention backward on the same values, (B, H, N, Dh),
    # eager: its graph is the autograd graph of one forward call
    qh, kh, vh = (bhnd(x, 12).requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
    doh = bhnd(do, 12)
    times["library_eager"] = [cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))]
    k1b_bound = bound(nbytes(q, k, v, do, q, k, v), 10 * 3 * 3 * b * 768,
                      torch.bfloat16)
    worst = {r: {k: max([v for n, v in errs.items() if n.endswith(k)
                         and (n.endswith(f"warp {k}") == (r == "warp"))],
                        default=0.0)
                 for k in ("dq", "dk", "dv")}
             for r in ("streaming", "warp")}
    print("[5 K1-bwd pairwise_attention_bwd] routes: bf16 on its grid (at "
          "most 3 tokens a side) 8 lanes a (row, head) on 16-byte register "
          "loads (counted "
          "pairwise_attention_bwd), else a warp a (row, head) (_warp); every "
          "case through the dispatch and the warp route | route per case: "
          + ", ".join(f"{n} {r}" for n, r in routes.items())
          + f" | launches {dict(launches)} | max_abs_err over "
          f"{len(routes)} cases: " + "; ".join(
              f"{r} " + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
              for r, w in worst.items())
          + " (per case: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + ") | two runs of each route bitwise equal | ms at (3, 4096, 768) "
          "bf16 (CUDA-graph replays in turns kernel, warp, plain, warp, "
          "kernel; eager with host launch cost; library = backward of "
          "scaled_dot_product_attention): " + ", ".join(
              f"{k} {' '.join(f'{t:.4f}' for t in v)}"
              for k, v in times.items())
          + f" | bound {k1b_bound['bound_ms']:.4f} ms "
          f"({k1b_bound['bound_by']}) | {card()}")
    return {"max_abs_err": max(worst["streaming"].values()),
            "warp_max_abs_err": max(worst["warp"].values()),
            "ms": min(times["kernel"]), "warp_ms": min(times["warp"]),
            "plain_ms": times["plain"][0],
            "library_ms": times["library_eager"][0],
            "launches": dict(launches), **k1b_bound}


def _hash_bwd_case(gen, n, levels, table, d, f=2, interpolation="linear",
                   table_size=None, nan_filled=False):
    """One K2-bwd case through the dispatch and the scalar route's own
    wrapper: {route: (max_abs_err, run-to-run max difference)}. With
    ``nan_filled`` the dispatch's output memory holds NaN before the call
    (the caching allocator hands back the block just freed), so a kernel
    that left an entry unwritten would show it."""
    coords = torch.rand((n, d), generator=gen, device="cuda")
    coords[: n // 8] = torch.randint(0, 17, (n // 8, d), generator=gen,
                                     device="cuda").float() / 16
    coords[0], coords[1] = 0.0, 1.0
    grad_out = torch.randn((n, levels * f), generator=gen, device="cuda")
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device="cuda")
    shape = (levels, table, f)
    ts = table_size or table
    kw = dict(interpolation=interpolation, table_size=table_size)
    ref = hash_encoding.hash_encode_bwd_plain(coords, grad_out, res, shape,
                                              **kw)
    abs_sum = hash_encoding.hash_encode_bwd_plain(coords, grad_out.abs(), res,
                                                  shape, **kw)
    route = ("hash_encode_bwd" if kernels.hash_bwd_dense_route(f)
             else "hash_encode_bwd_scalar")
    calls = {route: kernels.hash_encode_bwd}
    calls.setdefault("hash_encode_bwd_scalar", kernels.hash_encode_bwd_scalar)
    out = {}
    for counter, call in calls.items():
        run = lambda: call(coords, grad_out, res, shape, ts,  # noqa: E731
                           interpolation == "linear")
        if nan_filled and counter == route:
            filled = torch.full(shape, float("nan"), device="cuda")
            ptr = filled.data_ptr()
            del filled
        kernels.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        if kernels.launch_counts != expected_launches(**{counter: 1}):
            raise AssertionError(f"K2-bwd {counter}: launches "
                                 f"{kernels.launch_counts}")
        if nan_filled and counter == route and got.data_ptr() != ptr:
            raise AssertionError("K2-bwd: the output did not reuse the "
                                 "NaN-filled memory")
        if got.shape != shape or not bool(got.isfinite().all()):
            raise AssertionError(f"K2-bwd {counter}: output "
                                 f"{tuple(got.shape)} or non-finite values")
        diff = (got - ref).abs()
        if not bool((diff <= HASH_BWD_TOL * abs_sum).all()):
            raise AssertionError(f"K2-bwd {counter} beyond {HASH_BWD_TOL} of "
                                 f"sum|terms|: max_abs_err "
                                 f"{diff.max().item()}")
        out[counter] = (diff.max().item(), (got - run()).abs().max().item())
    return route, out


def phase_hash_bwd(gen) -> dict:
    """K2-bwd by both routes: the dispatch (the dense gradient written
    whole at F = 2) and the scalar route's own wrapper, at every case."""
    n = 4096
    cases = {
        "spatial L16 T2^19 D3": dict(levels=16, table=2 ** 19, d=3),
        "temporal L8 T2^17 D1": dict(levels=8, table=2 ** 17, d=1),
        "T=3001 D3": dict(levels=4, table=3001, d=3),
        "nearest D3": dict(levels=16, table=2 ** 19, d=3,
                           interpolation="nearest"),
        "D2 F3": dict(levels=4, table=4096, d=2, f=3),
        "D4 hashed into 1000 of 1024": dict(levels=4, table=1024, d=4,
                                            table_size=1000),
    }
    routes, errs, repeat = {}, {}, {}
    launches = collections.Counter()

    def record(name, route, out):
        routes[name] = route
        for counter, (err, rerun) in out.items():
            tag = name + ("" if counter == "hash_encode_bwd" else " scalar")
            errs[tag], repeat[tag] = err, rerun
            launches[counter] += 1

    for name, kw in cases.items():
        record(name, *_hash_bwd_case(gen, n, **kw))
    # the output memory NaN before the call; drawn from a generator of its
    # own, so that the later phases' draws stay as they were
    record("spatial, output NaN-filled", *_hash_bwd_case(
        torch.Generator(device="cuda").manual_seed(SEED), n, levels=16,
        table=2 ** 19, d=3, nan_filled=True))

    times = {}
    grid4d = astack_config().grid4d
    for name, hcfg in (("spatial", grid4d.spatial),
                       ("temporal", grid4d.temporal)):
        shape = (hcfg.n_levels, hcfg.hash_table_size,
                 hcfg.n_features_per_level)
        res = torch.tensor(hcfg.resolutions, dtype=torch.float32,
                           device="cuda")
        pool = [(torch.rand((n, hcfg.coords_dim), generator=gen,
                            device="cuda"),
                 torch.randn((n, hcfg.output_dim), generator=gen,
                             device="cuda")) for _ in range(16)]
        if name == "spatial":
            # coords, grad_out, resolutions in; the dense table gradient out
            k2b_bound = bound(
                nbytes(*pool[0], res) + 4 * math.prod(shape),
                2 * n * hcfg.output_dim * 2 ** hcfg.coords_dim, torch.float32)
        ts = hcfg.hash_table_size
        # the dispatch (the dense route at F = 2) and the scalar route (the
        # first design, after torch.zeros)
        calls = {
            "kernel": lambda c, g: kernels.hash_encode_bwd(
                c, g, res, shape, ts, True),
            "scalar": lambda c, g: kernels.hash_encode_bwd_scalar(
                c, g, res, shape, ts, True),
            "plain": lambda c, g: hash_encoding.hash_encode_bwd_plain(
                c, g, res, shape)}
        for label in ("kernel", "scalar", "plain", "scalar", "kernel"):
            inputs = itertools.cycle(pool)
            times.setdefault(f"{name}_{label}", []).append(
                graph_ms(lambda: calls[label](*next(inputs))))
        for label in ("kernel", "scalar", "plain"):
            inputs = itertools.cycle(pool)
            times[f"{name}_{label}_eager"] = [
                cuda_ms(lambda: calls[label](*next(inputs)))]
    worst = {r: max([e for t, e in errs.items()
                     if t.endswith(" scalar") == (r == "scalar")],
                    default=0.0) for r in ("dense", "scalar")}
    print("[6 K2-bwd hash_encode_bwd] routes: F = 2 the dense gradient "
          "written whole, a zeroing launch then the scatter (counted "
          "hash_encode_bwd), else scalar atomics into torch.zeros "
          "(_scalar); every case through the dispatch and the scalar route "
          "| route per case: " + ", ".join(f"{k} {v}"
                                           for k, v in routes.items())
          + f" | launches {dict(launches)} | max_abs_err over {len(routes)} "
          "cases: " + ", ".join(f"{r} {e:.3g}" for r, e in worst.items())
          + f" (tol {HASH_BWD_TOL} of each row's sum |terms|; per case: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + ") | run to run: " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in repeat.items())
          + " | ms at N=4096 (CUDA-graph replays in turns kernel, scalar, "
          "plain, scalar, kernel; eager with "
          "host launch cost; each includes zeroing or writing the whole "
          "table gradient): " + ", ".join(
              f"{k} {' '.join(f'{t:.4f}' for t in v)}"
              for k, v in times.items())
          + f" | spatial bound {k2b_bound['bound_ms']:.4f} ms "
          f"({k2b_bound['bound_by']}) | {card()}")
    return {"max_abs_err": worst["dense"], "scalar_max_abs_err": worst["scalar"],
            "ms": min(times["spatial_kernel"]),
            "scalar_ms": min(times["spatial_scalar"]),
            "plain_ms": times["spatial_plain"][0], "library_ms": None,
            "launches": dict(launches), **k2b_bound}


def _run_steps(trainer, state, batches, seed):
    """Train steps over ``batches`` from a generator seeded with ``seed``;
    returns per-step (loss, grad_norm) as floats."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for batch in batches:
        state, m = trainer.train_step(state, batch, g)
        out.append((m["loss/total"].item(), m["grad_norm"].item()))
    return out


def train_kernel_vs_plain(trainer, model, start, batches,
                          tol=TRAIN_TOL) -> dict:
    """Train steps over ``batches`` from the parameters ``start``, once with
    the kernels and once through the plain versions, each with a fresh
    optimizer and the same masks (one seed). The loss and grad norm of each
    step must agree to ``tol`` relative, the parameters after the last
    step to 3 * sum(lr)."""
    runs, params = {}, {}
    for label in ("kernel", "plain"):
        model.load_state_dict(start)
        st = trainer.init_state()
        kernels.reset_launch_counts()
        with plain_versions() if label == "plain" else contextlib.nullcontext():
            runs[label] = _run_steps(trainer, st, batches, seed=1)
        launched = any(kernels.launch_counts.values())
        if launched != (label == "kernel"):
            raise AssertionError(f"{label} run: launches "
                                 f"{kernels.launch_counts}")
        params[label] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
    lrs = [st.optimizer.learning_rate(i) for i in range(len(batches))]
    param_tol = 3 * sum(lrs)
    rel = {k: max(abs(a[i] - b[i]) / abs(b[i]) for a, b in
                  zip(runs["kernel"], runs["plain"]))
           for i, k in enumerate(("loss", "grad_norm"))}
    param_err = max((params["kernel"][n] - params["plain"][n]).abs().max()
                    .item() for n in params["kernel"])
    if any(rel[k] > tol[k] for k in tol) or param_err > param_tol:
        raise AssertionError(f"kernel vs plain train path: {runs}, params "
                             f"{param_err} (tol {param_tol})")
    return {"runs": runs, "rel": rel, "param_err": param_err,
            "param_tol": param_tol}


def loss_falls(trainer, model, start, cfg, batch,
               steps: int = LOSS_FALL_STEPS) -> list:
    """(loss, grad norm) of ``steps`` steps on one repeated batch at a
    constant learning rate of 1e-3 from ``start``; the loss must fall."""
    model.load_state_dict(start)
    fast = dataclasses.replace(cfg.optimizer, schedule="constant",
                               learning_rate=1e-3)
    st = TrainState(model, create_optimizer(model.parameters(), fast))
    falls = _run_steps(trainer, st, [batch] * steps, seed=2)
    if not falls[-1][0] < falls[0][0]:
        raise AssertionError(f"loss did not fall: {falls}")
    return falls


def phase_train(gen) -> dict:
    cfg = astack_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda")
    # the objective bench.py trains: no contrastive term
    trainer = Trainer(model, cfg, LossWeights(contrastive=0.0), seed=SEED)
    state = trainer.init_state()
    start = copy.deepcopy(model.state_dict())
    batches = [make_batch(gen, TRAIN_BATCH) for _ in range(TRAIN_STEPS)]
    eval_batches = [make_batch(gen, TRAIN_BATCH) for _ in range(2)]

    # the main path: Trainer.fit and Trainer.evaluate, counted
    kernels.reset_launch_counts()
    state, fit_metrics = trainer.fit(state, iter(batches), TRAIN_STEPS,
                                     log_every=TRAIN_STEPS)
    val = trainer.evaluate(state, eval_batches)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    want = expected_launches(
        hash_encode_fwd=K2_PER_FORWARD * (TRAIN_STEPS + 2),
        hash_encode_bwd=K2_PER_FORWARD * TRAIN_STEPS,
        pairwise_attention_fwd=K1_PER_FORWARD * (TRAIN_STEPS + 2),
        pairwise_attention_bwd=K1_PER_FORWARD * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps and 2 eval "
                             f"batches {launches} != {want}")
    for name, v in {**fit_metrics, **val}.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name} = {v}")

    cmp = train_kernel_vs_plain(trainer, model, start, batches)
    falls = loss_falls(trainer, model, start, cfg, batches[0])

    timing = train_timing(trainer, batches[0], iters=10)
    print(f"[7 train slice A-stack] B={TRAIN_BATCH}, masking on, fit "
          f"{TRAIN_STEPS} steps + evaluate 2 batches: launches {launches} | "
          f"fit loss {fit_metrics['loss/total']:.4f}, val loss "
          f"{val['loss/total']:.4f} | kernel vs plain path over "
          f"{TRAIN_STEPS} steps (loss, grad_norm): kernel "
          f"{cmp['runs']['kernel']}, plain {cmp['runs']['plain']}, rel diff "
          f"{cmp['rel']} (tol {TRAIN_TOL}), params max_abs "
          f"{cmp['param_err']:.3g} (tol 3*sum(lr) = {cmp['param_tol']:.3g}) "
          "| loss "
          f"on one batch at lr 1e-3: {falls[0][0]:.4f} -> "
          f"{falls[-1][0]:.4f} in {LOSS_FALL_STEPS} steps | step ms eager "
          f"(CUDA events over 10 steps, order kernel, plain, kernel, plain): "
          + turns(timing)
          + f" | {TRAIN_BATCH / timing['step_ms'] * 1e3:.0f} obs/s with the "
          f"kernels, {TRAIN_BATCH / timing['plain_step_ms'] * 1e3:.0f} with "
          f"the plain versions | peak mem of the kernel path "
          f"{timing['peak_gib']:.2f} GiB | {card()}")
    return {"launches": launches}


def attention_case(gen, b, h, nq, nk, dqk, dv, dtype, mask=False,
                   strided=False):
    """q, k, v (v a strided view of a wider projection when ``strided``, as
    MLA leaves it), dout, and a key mask whose batch row 0 sees no key."""
    q = torch.randn((b, h, nq, dqk), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, nk, dqk), generator=gen, device="cuda").to(dtype)
    if strided:
        v = torch.randn((b, nk, h, 2 * dv), generator=gen, device="cuda").to(
            dtype)[..., dv:].transpose(1, 2)
    else:
        v = torch.randn((b, h, nk, dv), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((b, h, nq, dv), generator=gen, device="cuda").to(dtype)
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=gen, device="cuda") > 0.3
        key_mask[0] = False
    return q, k, v, dout, key_mask


# K3's timed sites: (B, Nq, Dqk, Dv) over 8 heads x VISION_PATCHES keys, v
# strided as the MLA leaves it (not at the cross-attention): the multimodal
# train step's MLA and cross sites at B=512 (the JSON line's numbers, per
# step) and the flagship train step's MLA site
K3_SITES = {"mla": (MM_BATCH, 576, 48, 32), "cross": (MM_BATCH, 16, 64, 64),
            "flagship": (FLAGSHIP_TRAIN_BATCH, 576, 128, 128)}


def k3_fwd_floor_ms(b, nq, nk, dqk, dv, bound_ms: float) -> float:
    """The least time K3-fwd's TMA route needs at a site over 8 heads, by
    its design: q.k^T twice (the stats sweep and the output sweep) and P.V
    at the bf16 tensor peak, two exps a score at the exp units' rate, or
    the function's own bound (the bytes, where k's second read hits L2),
    whichever is largest."""
    pairs = b * 8 * nq * nk
    return max(2 * pairs * (2 * dqk + dv) / PEAK_FLOPS[torch.bfloat16] * 1e3,
               exp_floor_ms(2 * pairs), bound_ms)


def phase_vmem(gen) -> dict:
    errs, routes, route_err = {}, {}, collections.Counter()
    route_launches = collections.Counter()
    cases = {  # name: (B, H, Nq, Nk, Dqk, Dv, key mask, v strided)
        "MLA site B=512 576x576 Dqk48 Dv32": (MM_BATCH, 8, 576, 576, 48, 32,
                                               False, True),
        "cross site B=512 16x576 Dh64": (MM_BATCH, 8, 16, 576, 64, 64, False,
                                         False),
        "ragged 100x260 Dqk48 Dv80 masked": (4, 3, 100, 260, 48, 80, True,
                                             False),
        "Nk=1024 Dh128 masked": (8, 4, 64, 1024, 128, 128, True, False),
        # the flagship's vision MLA at 576 patches (its train step)
        "flagship MLA site B=64 576x576 Dh128": (FLAGSHIP_TRAIN_BATCH, 8,
                                                 576, 576, 128, 128, False,
                                                 True),
        # the MLA's widths with masked keys (192-row blocks), and 128-row
        # blocks over ragged keys
        "MLA widths 576x576 masked": (4, 8, 576, 576, 48, 32, True, True),
        "200x500 Dh64 masked": (4, 2, 200, 500, 64, 64, True, False),
        # off TMA's grid: the mma.sync route
        "Dqk40 Dv36 100x300 masked": (2, 2, 100, 300, 40, 36, True, False),
    }
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (b, h, nq, nk, dqk, dv, mask, strided) in cases.items():
            q, k, v, _, key_mask = attention_case(gen, b, h, nq, nk, dqk,
                                                  dv, dtype, mask, strided)
            route = attention_route(q, k, v)
            kw = dict(scale=dqk ** -0.5, key_mask=key_mask)
            kernels.reset_launch_counts()
            out = attention_vmem.vmem_attention(q, k, v, **kw)
            want = expected_launches(**{f"vmem_attention_fwd{route}": 1})
            if kernels.launch_counts != want:
                raise AssertionError(f"K3 {name} {tag}: launches "
                                     f"{kernels.launch_counts} != {want}")
            route_launches.update({k: v for k, v in
                                   kernels.launch_counts.items() if v})
            key = f"{name} {tag}"
            routes[key] = route or "TMA"
            ref = attention_vmem.vmem_attention_plain(q, k, v, **kw)
            if out.shape != (b, h, nq, dv) or out.dtype != dtype:
                raise AssertionError(f"K3 {name}: {out.shape} {out.dtype}")
            if mask and not bool((out[0] == 0).all()):
                raise AssertionError(f"K3 {name}: the all-masked row is not 0")
            err = max_err(out, ref)
            errs[key] = err
            route_err[route] = max(route_err[route], err)
            if err > VMEM_TOL[dtype]:
                raise AssertionError(f"K3 {key}: max_abs_err {err} > "
                                     f"{VMEM_TOL[dtype]}")
            if not torch.equal(kernels.vmem_attention_fwd(
                    q, k, v, kw["scale"], key_mask), out):
                raise AssertionError(f"K3 {key}: two runs differ")
            del q, k, v, out, ref

    # the slice's two sites at B=512 in bf16 and the flagship's MLA site
    # (its train step's): the TMA route's kernel and the mma.sync route's on
    # the same tensors (each held to VMEM_TOL of the plain version there),
    # plain, the library's fused attention (a yardstick only), the bound and
    # the TMA route's own floor
    sites = {}
    for name, (b, nq, dqk, dv) in K3_SITES.items():
        q, k, v, _, _ = attention_case(gen, b, 8, nq, VISION_PATCHES, dqk,
                                       dv, torch.bfloat16,
                                       strided=name != "cross")
        sc = dqk ** -0.5
        ref = attention_vmem.vmem_attention_plain(q, k, v, scale=sc)
        mma_err = max_err(kernels.vmem_attention_fwd_mma(q, k, v, sc), ref)
        if mma_err > VMEM_TOL[torch.bfloat16]:
            raise AssertionError(f"K3 {name} site, mma.sync route: "
                                 f"max_abs_err {mma_err}")
        route_err["_mma"] = max(route_err["_mma"], mma_err)
        del ref
        t = {
            "ms": cuda_ms(lambda: kernels.vmem_attention_fwd_tma(q, k, v, sc),
                          iters=10, warmup=2),
            "mma_ms": cuda_ms(lambda: kernels.vmem_attention_fwd_mma(
                q, k, v, sc), iters=10, warmup=2),
            "plain_ms": cuda_ms(lambda: attention_vmem.vmem_attention_plain(
                q, k, v, scale=sc), iters=5, warmup=1),
            "library_ms": library_fwd_ms(q, k, v, sc, iters=10),
        }
        flops = 2 * b * 8 * nq * VISION_PATCHES * (dqk + dv)
        t.update(bound(nbytes(q, k, v) + b * 8 * nq * dv * 2, flops,
                       torch.bfloat16))
        t["floor_ms"] = k3_fwd_floor_ms(b, nq, VISION_PATCHES, dqk, dv,
                                        t["bound_ms"])
        t["tflops"] = flops / t["ms"] / 1e9
        sites[name] = t
        del q, k, v
    print("[8 K3 vmem_attention_fwd] routes per case (TMA = wgmma over TMA "
          "tiles, _mma, _fp32): " + ", ".join(
              f"{k} {v}" for k, v in routes.items())
          + "; two runs of each case bitwise equal | max_abs_err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {tags(VMEM_TOL)}); the mma.sync route at the timed "
          f"sites {route_err['_mma']:.3g}"
          + " | ms bf16, the sites at B=512 and the flagship's MLA site at "
          f"B={FLAGSHIP_TRAIN_BATCH} (device, CUDA events; the function's "
          "TFLOP/s; library = scaled_dot_product_attention; floor = the TMA "
          "route's design: q.k^T twice and P.V, two exps a score, or the "
          "bound): "
          + ", ".join(
              f"{n} TMA route {t['ms']:.4f} ({t['tflops']:.2f} TFLOP/s), "
              f"mma.sync route {t['mma_ms']:.4f}, plain {t['plain_ms']:.4f}, "
              f"library {fmt(t['library_ms'])}, bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}), floor {t['floor_ms']:.4f}"
              for n, t in sites.items())
          + f" | {card()}")
    flagship = sites.pop("flagship")
    return {**per_step(errs, sites), "max_abs_err": route_err[""],
            "mma_max_abs_err": route_err["_mma"],
            "mma_ms": sum(t["mma_ms"] for t in sites.values()),
            "launches": dict(route_launches), "flagship": flagship}


def multimodal_config(hidden_dim: int = 512) -> DeepEarthConfig:
    """The configuration of tools/bench_multimodal.py, bf16 compute (the
    tests narrow it with ``hidden_dim``)."""
    cfg = DeepEarthConfig(
        hidden_dim=hidden_dim, n_heads=8, n_layers=4,
        grid4d=Grid4DConfig(n_spatial_levels=16, n_temporal_levels=8,
                            hash_table_size=2 ** 19),
        modality_encoder=TransformerConfig(hidden_dim=256, n_heads=4,
                                           n_layers=2),
        compute_dtype=torch.bfloat16,
    )
    cfg.add_modality(ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=232))
    cfg.add_modality(ModalityConfig(name="vision", input_dim=1408,
                                    n_tokens=16, encoder_layers=1,
                                    encoder_heads=8))
    cfg.add_modality(ModalityConfig(name="language", input_dim=7168,
                                    n_tokens=4, encoder_layers=1,
                                    encoder_heads=8))
    return cfg


def make_mm_batch(gen, n, patches=VISION_PATCHES):
    """One request: n observations, each with a place and time, a species,
    V-JEPA2 patch embeddings (576 of an image, 4608 of a clip) and one
    language embedding."""
    return {
        "xyzt": torch.rand((n, 4), generator=gen, device="cuda"),
        "modalities": {
            "species": torch.randint(0, 232, (n,), generator=gen,
                                     device="cuda"),
            "vision": torch.randn((n, patches, 1408), generator=gen,
                                  device="cuda").to(torch.bfloat16),
            "language": torch.randn((n, 7168), generator=gen,
                                    device="cuda").to(torch.bfloat16),
        },
    }


def host_ms(fn, iters: int = 10) -> list:
    """Synchronised host wall time of each of ``iters`` calls, in ms."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def kernel_breakdown(fn, n_calls: int = 3):
    """From torch.profiler over ``n_calls`` calls: (kernel name, device ms
    per call, launches per call) and (torch op, device ms of the kernels it
    launched itself per call, calls per call), each the largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    kernel_rows, op_rows = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us <= 0:
            continue
        row = (e.key, dev_us / 1e3 / n_calls, e.count / n_calls)
        # a user annotation (the optimizer's step) spans kernels that are
        # rows of their own: it goes with the ops
        kernel = ("CUDA" in str(e.device_type)
                  and not e.key.startswith("Optimizer."))
        (kernel_rows if kernel else op_rows).append(row)
    return (sorted(kernel_rows, key=lambda r: -r[1]),
            sorted(op_rows, key=lambda r: -r[1]))


def phase_multimodal(gen) -> dict:
    cfg = multimodal_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda",
                           native_seq_lens={"vision": VISION_PATCHES}).eval()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [make_mm_batch(gen, n) for n in MM_REQUEST_SIZES]
    want = expected_launches(hash_encode_fwd=2 * 2,
                    vmem_attention_fwd=2 * K3_PER_FORWARD)

    # the main path: requests through the user's entry points, counted, with
    # every plain version made to raise
    kernels.reset_launch_counts()
    outs = []
    with torch.inference_mode(), plain_versions_refused():
        for batch in batches:
            before = dict(kernels.launch_counts)
            outs.append(model(batch))
            feats = model.extract_features(batch)
            got = {k: kernels.launch_counts[k] - before[k] for k in before}
            if got != want:
                raise AssertionError(f"launches per request {got} != {want}")
            if not torch.equal(feats, outs[-1]["fused_representation"]):
                raise AssertionError("extract_features != forward")
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)

    errs, repeat = {}, {}
    with torch.inference_mode():
        for batch, out in zip(batches, outs):
            n = batch["xyzt"].shape[0]
            shapes = {"fused_representation": (n, 512),
                      "all_tokens": (n, 23, 512), "spatial": (n, 3),
                      "temporal": (n, 1), "species": (n, 232),
                      "vision": (n, 1408), "language": (n, 7168)}
            got = {"fused_representation": out["fused_representation"],
                   "all_tokens": out["all_tokens"], **out["reconstructions"]}
            for key, shape in shapes.items():
                t = got[key]
                if tuple(t.shape) != shape or not bool(t.isfinite().all()):
                    raise AssertionError(f"B={n} {key}: shape {tuple(t.shape)}"
                                         f" or non-finite values")
            kernels.reset_launch_counts()
            with plain_versions():
                ref = model(batch)
            if any(kernels.launch_counts.values()):
                raise AssertionError("the plain run launched a kernel")
            errs[n] = output_diff(out, ref)
            del ref
            repeat[n] = output_diff(out, model(batch))
    for n, e in errs.items():
        if any(e[k] > MM_SLICE_TOL[k] for k in MM_SLICE_TOL):
            raise AssertionError(f"kernel path vs plain path: {errs}")

    timing = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for batch in batches:
            n = batch["xyzt"].shape[0]
            walls = sorted(host_ms(lambda: model.extract_features(batch)))
            timing[n] = {
                "host_median_ms": walls[len(walls) // 2],
                "host_max_ms": walls[-1],
                "device_ms": cuda_ms(lambda: model.extract_features(batch),
                                     iters=10, warmup=2)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30  # kernel path
        big = batches[-1]
        breakdown, by_op = kernel_breakdown(
            lambda: model.extract_features(big))
        with plain_versions():
            timing["plain_ms"] = cuda_ms(lambda: model.extract_features(big),
                                         iters=5, warmup=1)
    obs_per_s = MM_BATCH / timing[MM_BATCH]["device_ms"] * 1e3
    print(f"[9 slice multimodal] {n_params / 1e6:.1f}M params | requests "
          f"{MM_REQUEST_SIZES} finite, launches per forward K3 "
          f"{K3_PER_FORWARD} K2 2 K1 0, no plain version reached (routes "
          f"over the run: {route_counts(launches, 'vmem_attention_fwd')}) "
          "| vs plain "
          "path " + ", ".join(
              f"B={k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
              for k, v in errs.items())
          + f" (tol {MM_SLICE_TOL}; kernel path run twice: " + ", ".join(
              f"B={k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
              for k, v in repeat.items())
          + ") | per request, host wall median/max and CUDA-event ms: "
          + ", ".join(f"B={n} {timing[n]['host_median_ms']:.3f}/"
                      f"{timing[n]['host_max_ms']:.3f}, "
                      f"{timing[n]['device_ms']:.3f}"
                      for n in MM_REQUEST_SIZES)
          + f" | B={MM_BATCH}: {obs_per_s:.0f} obs/s, plain versions "
          f"{timing['plain_ms']:.3f} ms | peak mem of the kernel path "
          f"{peak:.2f} GiB | {card()}")
    print_breakdown(9, f"B={MM_BATCH} forward", "forward", breakdown, by_op)
    return {"launches": launches}


def check_grads(name, got, ref, dtype, key_mask=None) -> float:
    """Each of dq, dk, dv within BWD_TOL of its plain version's largest
    entry; with a key mask, batch row 0 (no visible key) has dq exactly 0
    and masked keys dk and dv exactly 0. Returns the largest error."""
    worst = 0.0
    for label, a, r in zip(("dq", "dk", "dv"), got, ref):
        if a.shape != r.shape or a.dtype != r.dtype or not a.is_contiguous():
            raise AssertionError(f"{name} {label}: {a.shape} {a.dtype}")
        err = max_err(a, r)
        tol = BWD_TOL[dtype] * r.float().abs().max().item() + 1e-6
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")
        worst = max(worst, err)
    if key_mask is not None:
        hidden = ~key_mask[:, None, :, None]
        if not (bool((got[0][0] == 0).all())
                and all(bool((g.masked_select(hidden) == 0).all())
                        for g in got[1:])):
            raise AssertionError(f"{name}: gradients where no key is seen")
    return worst


def attn_bwd_flops(b, h, pairs, dqk, dv) -> int:
    """q.k^T, dout.v^T, p^T.dout, ds.k and ds^T.q over ``pairs`` (query,
    key) pairs of each (b, h)."""
    return 2 * b * h * pairs * (3 * dqk + 2 * dv)


def fused_sdpa():
    """scaled_dot_product_attention held to its fused backends: the math
    backend would materialise the scores (43 GB at the 4608-patch MLA,
    B=64)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION])


def library_fwd_ms(q, k, v, scale, iters=5) -> Optional[float]:
    """scaled_dot_product_attention on the same tensors, a yardstick only;
    None where no fused backend takes them."""
    try:
        with fused_sdpa():
            return cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters=iters, warmup=1)
    except RuntimeError:
        return None


def library_bwd_ms(q, k, v, dout, scale) -> Optional[float]:
    """The backward of scaled_dot_product_attention on the same tensors,
    through torch.autograd.grad, eager; a yardstick only, None where no
    fused backend takes them."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    try:
        with fused_sdpa():
            out = F.scaled_dot_product_attention(*leaves, scale=scale)
            return cuda_ms(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True), iters=5, warmup=1)
    except RuntimeError:
        return None


def fmt(ms: Optional[float]) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def phase_vmem_bwd(gen) -> dict:
    errs, routes, route_err = {}, {}, collections.Counter()
    route_launches = collections.Counter()
    cases = {  # name: (B, H, Nq, Nk, Dqk, Dv, key mask, v strided)
        "MLA site B=512 576x576 Dqk48 Dv32": (MM_BATCH, 8, 576, 576, 48, 32,
                                               False, True),
        "cross site B=512 16x576 Dh64": (MM_BATCH, 8, 16, 576, 64, 64, False,
                                         False),
        "ragged 100x260 Dqk48 Dv80 masked": (4, 3, 100, 260, 48, 80, True,
                                             False),
        "Nk=1024 Dh128 masked": (8, 4, 64, 1024, 128, 128, True, False),
        "flagship MLA site B=64 576x576 Dh128": (FLAGSHIP_TRAIN_BATCH, 8,
                                                 576, 576, 128, 128, False,
                                                 True),
        # off TMA's grid: the mma.sync route
        "Dqk40 Dv36 100x300 masked": (2, 2, 100, 300, 40, 36, True, False),
    }
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (b, h, nq, nk, dqk, dv, mask, strided) in cases.items():
            q, k, v, do, key_mask = attention_case(
                gen, b, h, nq, nk, dqk, dv, dtype, mask, strided)
            route = attention_route(q, k, v)
            kernels.reset_launch_counts()
            got = kernels.vmem_attention_bwd(q, k, v, do, dqk ** -0.5,
                                             key_mask)
            want = expected_launches(**{f"vmem_attention_bwd{route}": 1})
            if kernels.launch_counts != want:
                raise AssertionError(f"K3-bwd {name} {tag}: launches "
                                     f"{kernels.launch_counts} != {want}")
            route_launches.update({k: v for k, v in
                                   kernels.launch_counts.items() if v})
            key = f"{name} {tag}"
            routes[key] = route or "TMA"
            ref = attention_vmem.vmem_attention_bwd_plain(
                q, k, v, do, scale=dqk ** -0.5, key_mask=key_mask)
            errs[key] = check_grads(f"K3-bwd {key}", got, ref, dtype,
                                    key_mask)
            route_err[route] = max(route_err[route], errs[key])
            again = kernels.vmem_attention_bwd(q, k, v, do, dqk ** -0.5,
                                               key_mask)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"K3-bwd {key}: two runs differ")
            del q, k, v, do, got, ref, again

    # the slice's two sites at B=512 in bf16 and the flagship's MLA site:
    # the TMA route's kernels, the mma.sync route's on the same tensors,
    # plain, the library's attention backward (a yardstick only), the bound
    sites = {}
    for name, (b, nq, dqk, dv) in K3_SITES.items():
        q, k, v, do, _ = attention_case(gen, b, 8, nq, VISION_PATCHES, dqk,
                                        dv, torch.bfloat16,
                                        strided=name != "cross")
        sc = dqk ** -0.5
        t = {
            "ms": cuda_ms(lambda: kernels.vmem_attention_bwd_tma(
                q, k, v, do, sc), iters=10, warmup=2),
            "mma_ms": cuda_ms(lambda: kernels.vmem_attention_bwd_mma(
                q, k, v, do, sc), iters=10, warmup=2),
            "plain_ms": cuda_ms(
                lambda: attention_vmem.vmem_attention_bwd_plain(
                    q, k, v, do, scale=sc), iters=3, warmup=1),
            "library_ms": library_bwd_ms(q, k, v, do, sc),
        }
        flops = attn_bwd_flops(b, 8, nq * VISION_PATCHES, dqk, dv)
        t.update(bound(nbytes(q, k, v, do, q, k, v), flops, torch.bfloat16))
        t["tflops"] = flops / t["ms"] / 1e9
        sites[name] = t
        del q, k, v, do
    print("[10 K3-bwd vmem_attention_bwd] routes per case (TMA = wgmma over "
          "TMA tiles, _mma, _fp32): " + ", ".join(
              f"{k} {v}" for k, v in routes.items())
          + "; two runs of each case bitwise equal | max_abs_err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {tags(BWD_TOL)} of each gradient's largest entry)"
          + " | ms bf16, the sites at B=512 and the flagship's MLA site at "
          f"B={FLAGSHIP_TRAIN_BATCH} (device, CUDA events; library = "
          "backward of scaled_dot_product_attention): " + ", ".join(
              f"{n} TMA route {t['ms']:.4f} ({t['tflops']:.2f} TFLOP/s), "
              f"mma.sync route {t['mma_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, library {fmt(t['library_ms'])}, bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']})"
              for n, t in sites.items())
          + f" | {card()}")
    flagship = sites.pop("flagship")
    return {**per_step(errs, sites), "max_abs_err": route_err[""],
            "mma_max_abs_err": route_err["_mma"],
            "mma_ms": sum(t["mma_ms"] for t in sites.values()),
            "launches": dict(route_launches), "flagship": flagship}


def per_step(errs, sites) -> dict:
    """A kernel's JSON numbers when one step runs it at several sites: the
    sites' times and bounds added."""
    total = {key: sum(t[key] for t in sites.values())
             for key in ("ms", "plain_ms", "bound_ms")}
    library = [t["library_ms"] for t in sites.values()]
    total["library_ms"] = None if None in library else sum(library)
    by_bytes = sum(t["bound_ms"] for t in sites.values()
                   if t["bound_by"] == "bytes")
    return {"max_abs_err": max(errs.values()), **total,
            "bound_by": "bytes" if 2 * by_bytes >= total["bound_ms"]
            else "operations", "sites": sites}


def check_flash_out(name, out, ref, dtype) -> float:
    """K4-fwd's output against its plain version's: the largest error within
    VMEM_TOL (fp32) or K4_MAX_REL of the plain output's largest entry (bf16),
    the mean error within K4_MEAN_REL of the mean |plain|. Returns the
    largest error and the mean error over the mean |plain|."""
    err = (out.float() - ref.float()).abs()
    top = ref.float().abs()
    tol = (VMEM_TOL[dtype] if dtype == torch.float32
           else K4_MAX_REL * top.max().item() + 1e-6)
    mean_rel = err.mean().item() / max(top.mean().item(), 1e-30)
    if not (err.max().item() <= tol and mean_rel <= K4_MEAN_REL):
        raise AssertionError(f"K4-fwd {name}: max_abs_err {err.max().item()} "
                             f"(tol {tol}), mean over mean |plain| {mean_rel} "
                             f"(tol {K4_MEAN_REL})")
    return err.max().item(), mean_rel


def check_flash(name, q, k, v, do, out, lse, grads, key_mask=None,
                causal=False, chunk=None) -> tuple:
    """K4-fwd's (out, lse) and K4-bwd's grads on one case against the plain
    versions, run ``chunk`` batch rows at a time (the plain version holds
    (chunk, H, N, N) fp32 scores); an all-masked row's output must be 0.
    Returns the largest output error, the mean output error over the mean
    |plain|, and the largest gradient error."""
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal)
    chunk = chunk or q.shape[0]
    parts = []
    for i in range(0, q.shape[0], chunk):
        rows = slice(i, i + chunk)
        mask = None if key_mask is None else key_mask[rows]
        ref, ref_lse = flash_attention.flash_attention_plain(
            q[rows], k[rows], v[rows], return_lse=True, key_mask=mask, **kw)
        parts.append((ref, ref_lse, *flash_attention.flash_attention_bwd_plain(
            q[rows], k[rows], v[rows], out[rows], lse[rows], do[rows],
            key_mask=mask, **kw)))
    ref, ref_lse, *ref_grads = (torch.cat(x) for x in zip(*parts))
    del parts
    if out.shape != ref.shape or out.dtype != q.dtype:
        raise AssertionError(f"K4 {name}: {out.shape} {out.dtype}")
    if key_mask is not None and not bool((out[0] == 0).all()):
        raise AssertionError(f"K4 {name}: the all-masked row is not 0")
    finite = ref_lse.isfinite()
    if not (torch.equal(lse.isinf(), ~finite) and max_err(
            lse[finite], ref_lse[finite]) <= K4_LSE_TOL):
        raise AssertionError(f"K4 {name}: log-sum-exp differs")
    return (*check_flash_out(name, out, ref, q.dtype),
            check_grads(f"K4-bwd {name}", grads, ref_grads, q.dtype,
                        key_mask))


def check_flash_rows(name, q, k, v, out, lse) -> tuple:
    """K4-fwd's (out, lse) alone (no mask, not causal) against its plain
    version, CLIP_PLAIN_BATCH batch rows at a time. Returns
    check_flash_out's numbers."""
    parts = [flash_attention.flash_attention_plain(
        q[i:i + CLIP_PLAIN_BATCH], k[i:i + CLIP_PLAIN_BATCH],
        v[i:i + CLIP_PLAIN_BATCH], scale=q.shape[-1] ** -0.5,
        return_lse=True) for i in range(0, q.shape[0], CLIP_PLAIN_BATCH)]
    ref, ref_lse = (torch.cat(x) for x in zip(*parts))
    del parts
    if not max_err(lse, ref_lse) <= K4_LSE_TOL:
        raise AssertionError(f"K4 {name}: log-sum-exp differs")
    return check_flash_out(name, out, ref, q.dtype)


def attention_route(q, k, v) -> str:
    """The suffix of the K3-fwd, K3-bwd, K4-fwd and K4-bwd counters these
    tensors launch (the four TMA routes take the same shapes and
    strides)."""
    if kernels.flash_bwd_tma_route(
            q.dtype, q.shape[-1], v.shape[-1],
            [s for x in (q, k, v) for s in kernels._tma_strides(x)]):
        return ""
    return "_mma" if q.dtype == torch.bfloat16 else "_fp32"


# K4's timed shapes: (B, Dqk, Dv) over 8 heads x CLIP_PATCHES, v strided as
# the MLA leaves it: the multimodal model's vision MLA at CLIP_PLAIN_BATCH
# and at its train step's batch, the flagship's at CLIP_PLAIN_BATCH, at the
# 4608-patch flagship step's largest batch (PERF.md section 4) and at its
# forward's B=64 (the forward only: no train step runs it)
FLASH_TIMED = ((CLIP_PLAIN_BATCH, 48, 32), (CLIP_BATCH, 48, 32),
               (CLIP_PLAIN_BATCH, 128, 128), (32, 128, 128),
               (FLAGSHIP_REQUEST_SIZES[-1], 128, 128))
# exps per SM and clock (MUFU.EX2, 16 a clock on each Hopper SM)
EXPS_PER_SM_CLOCK = 16


def exp_floor_ms(n_exps: float) -> float:
    """The least time the card's exp units need for ``n_exps`` exps at its
    largest SM clock (nvidia-smi's clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exps / (EXPS_PER_SM_CLOCK * sms * mhz * 1e6) * 1e3


def phase_flash(gen) -> tuple:
    torch.cuda.empty_cache()
    errs = {"fwd": {}, "mean": {}, "bwd": {}}
    routes = {}
    route_err = {"fwd": collections.Counter(), "bwd": collections.Counter()}
    route_launches = collections.Counter()
    cases = {  # name: (B, H, N, Dqk, Dv, key mask, causal, v strided)
        "MLA clip B=1 4608 Dqk48 Dv32": (1, 8, CLIP_PATCHES, 48, 32, False,
                                         False, True),
        "causal N=2048 Dh64": (2, 4, 2048, 64, 64, False, True, False),
        "masked N=1000 Dqk48 Dv32": (3, 2, 1000, 48, 32, True, False, False),
        "masked causal N=1500 Dh128": (2, 2, 1500, 128, 128, True, True,
                                       False),
        # the flagship's vision MLA over a clip
        "flagship MLA clip B=1 4608 Dh128": (1, 8, CLIP_PATCHES, 128, 128,
                                             False, False, True),
        # off TMA's grid: the mma.sync route
        "Dqk40 Dv36 N=700": (2, 2, 700, 40, 36, False, False, False),
    }
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (b, h, n, dqk, dv, mask, causal, strided) in cases.items():
            q, k, v, do, key_mask = attention_case(
                gen, b, h, n, n, dqk, dv, dtype, mask, strided)
            sc = dqk ** -0.5
            key = f"{name} {tag}"
            route = attention_route(q, k, v)
            kernels.reset_launch_counts()
            out, lse = kernels.flash_attention_fwd(q, k, v, sc, key_mask,
                                                   causal)
            got = kernels.flash_attention_bwd(q, k, v, out, lse, do, sc,
                                              key_mask, causal)
            want = expected_launches(**{f"flash_attention_fwd{route}": 1,
                                        f"flash_attention_bwd{route}": 1})
            if kernels.launch_counts != want:
                raise AssertionError(f"K4 {key}: launches "
                                     f"{kernels.launch_counts} != {want}")
            route_launches.update({k: v for k, v in
                                   kernels.launch_counts.items() if v})
            routes[key] = route or "TMA"
            (errs["fwd"][key], errs["mean"][key],
             errs["bwd"][key]) = check_flash(
                key, q, k, v, do, out, lse, got, key_mask, causal)
            for d in ("fwd", "bwd"):
                route_err[d][route] = max(route_err[d][route], errs[d][key])
            again = kernels.flash_attention_bwd(q, k, v, out, lse, do, sc,
                                                key_mask, causal)
            out2, lse2 = kernels.flash_attention_fwd(q, k, v, sc, key_mask,
                                                     causal)
            if not (all(torch.equal(x, y) for x, y in zip(got, again))
                    and torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError(f"K4 {key}: two runs differ")
            del q, k, v, do, out, lse, got, again, out2, lse2

    # the timed shapes in bf16: both kernels held against the plain
    # versions (CLIP_PLAIN_BATCH rows at a time), then K4-fwd and K4-bwd on
    # the TMA route and on the mma.sync route, the library and the bound
    # (the forward's beside the exp units' floor), and the plain versions'
    # time at CLIP_PLAIN_BATCH; at B=64 and 128-wide heads the forward only
    timing = {}
    for b, dqk, dv in FLASH_TIMED:
        torch.cuda.empty_cache()
        with_bwd = b <= CLIP_BATCH and (dqk, b) != (128, CLIP_BATCH)
        q, k, v, do, _ = attention_case(gen, b, 8, CLIP_PATCHES,
                                        CLIP_PATCHES, dqk, dv, torch.bfloat16,
                                        strided=True)
        sc = dqk ** -0.5
        kernels.reset_launch_counts()
        out, lse = kernels.flash_attention_fwd(q, k, v, sc)
        got = (kernels.flash_attention_bwd(q, k, v, out, lse, do, sc)
               if with_bwd else None)
        route_launches.update({k: v for k, v in kernels.launch_counts.items()
                               if v})
        if kernels.launch_counts != expected_launches(
                flash_attention_fwd=1, flash_attention_bwd=int(with_bwd)):
            raise AssertionError(f"K4 B={b} {dqk}/{dv}: not the TMA routes")
        name = f"MLA clip B={b} 4608 Dqk{dqk} Dv{dv} bfloat16"
        if with_bwd:
            errs["fwd"][name], errs["mean"][name], errs["bwd"][name] = (
                check_flash(name, q, k, v, do, out, lse, got,
                            chunk=CLIP_PLAIN_BATCH))
            route_err["bwd"][""] = max(route_err["bwd"][""],
                                       errs["bwd"][name])
        else:
            errs["fwd"][name], errs["mean"][name] = check_flash_rows(
                name, q, k, v, out, lse)
        route_err["fwd"][""] = max(route_err["fwd"][""], errs["fwd"][name])
        del got
        torch.cuda.empty_cache()
        pairs = CLIP_PATCHES ** 2
        fwd_flops = 2 * b * 8 * pairs * (dqk + dv)
        bwd_flops = attn_bwd_flops(b, 8, pairs, dqk, dv)
        fwd = {"ms": cuda_ms(lambda: kernels.flash_attention_fwd_tma(
                   q, k, v, sc), iters=5, warmup=1),
               "mma_ms": cuda_ms(lambda: kernels.flash_attention_fwd_mma(
                   q, k, v, sc), iters=3, warmup=1),
               "library_ms": library_fwd_ms(q, k, v, sc),
               "exp_floor_ms": exp_floor_ms(b * 8 * pairs)}
        fwd.update(bound(nbytes(q, k, v, out, lse), fwd_flops,
                         torch.bfloat16))
        bwd = None
        if with_bwd:
            bwd = {"ms": cuda_ms(lambda: kernels.flash_attention_bwd(
                       q, k, v, out, lse, do, sc), iters=5, warmup=1),
                   "mma_ms": cuda_ms(lambda: kernels.flash_attention_bwd_mma(
                       q, k, v, out, lse, do, sc), iters=3, warmup=1),
                   "library_ms": library_bwd_ms(q, k, v, do, sc)}
            bwd.update(bound(nbytes(q, k, v, out, lse, do, q, k, v),
                             bwd_flops, torch.bfloat16))
        if b == CLIP_PLAIN_BATCH:
            fwd["plain_ms"] = cuda_ms(
                lambda: flash_attention.flash_attention_plain(q, k, v,
                                                              scale=sc),
                iters=2, warmup=1)
            bwd["plain_ms"] = cuda_ms(
                lambda: flash_attention.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, scale=sc), iters=2, warmup=1)
        fwd["tflops"] = fwd_flops / fwd["ms"] / 1e9
        if bwd:
            bwd["tflops"] = bwd_flops / bwd["ms"] / 1e9
        timing[(b, dqk, dv)] = {"fwd": fwd, "bwd": bwd}
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()

    def row(t):
        return (f"TMA route {t['ms']:.3f} ({t['tflops']:.1f} TFLOP/s), "
                + f"mma.sync route {t['mma_ms']:.3f}, "
                + (f"plain {t['plain_ms']:.3f}, " if "plain_ms" in t else "")
                + f"library {fmt(t['library_ms'])}, bound "
                f"{t['bound_ms']:.3f} ({t['bound_by']})"
                + (f", exp floor {t['exp_floor_ms']:.3f}"
                   if "exp_floor_ms" in t else ""))
    for d in ("fwd", "bwd"):
        print(f"[11 K4-{d} flash_attention_{d}] "
              + ("routes per case (TMA = wgmma over TMA tiles, _mma, "
                 "_fp32): " + ", ".join(f"{k} {v}" for k, v in routes.items())
                 + "; two runs of each case bitwise equal | "
                 if d == "bwd" else "")
              + "max_abs_err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs[d].items())
              + (f" (tol fp32 {VMEM_TOL[torch.float32]}, bf16 {K4_MAX_REL} "
                 "of the largest entry; lse "
                 f"{K4_LSE_TOL}) | mean error over mean |plain| " + ", ".join(
                     f"{k} {v:.3g}" for k, v in errs["mean"].items())
                 + f" (tol {K4_MEAN_REL})" if d == "fwd" else
                 f" (tol {tags(BWD_TOL)} of each gradient's largest entry)")
              + f" | ms, 8 heads x {CLIP_PATCHES} patches, v strided, bf16 "
              "(device, CUDA events; library = scaled_dot_product_attention"
              + (")" if d == "fwd" else " backward)") + ": " + "; ".join(
                  f"B={b} Dqk {dqk} Dv {dv} {row(t[d])}"
                  for (b, dqk, dv), t in timing.items() if t[d])
              + f" | {card()}")
    base = timing[(CLIP_PLAIN_BATCH, 48, 32)]
    keys = ("ms", "mma_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return tuple({"max_abs_err": route_err[d][""],
                  "mma_max_abs_err": route_err[d]["_mma"],
                  "launches": dict(route_launches),
                  **{k: base[d][k] for k in keys}} for d in ("fwd", "bwd"))


def train_timing(trainer, batch, iters=5, plain=True) -> dict:
    """Eager train step ms by CUDA events, in turns kernel, plain, kernel,
    plain (without ``plain``: kernel, kernel), and the peak memory of the
    kernel path."""
    st = trainer.init_state()
    timing = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    labels = (("kernel", "plain", "kernel_again", "plain_again") if plain
              else ("kernel", "kernel_again"))
    for label in labels:
        g = torch.Generator(device="cuda").manual_seed(3)
        with (plain_versions() if label.startswith("plain")
              else contextlib.nullcontext()):
            timing[label] = cuda_ms(
                lambda: trainer.train_step(st, batch, g), iters=iters,
                warmup=1)
        if label == "kernel":
            timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timing["step_ms"] = min(timing["kernel"], timing["kernel_again"])
    if plain:
        timing["plain_step_ms"] = min(timing["plain"], timing["plain_again"])
    return timing


def turns(timing) -> str:
    return ", ".join(f"{k} {timing[k]:.3f}" for k in
                     ("kernel", "plain", "kernel_again", "plain_again")
                     if k in timing)


def phase_mm_train(gen) -> dict:
    torch.cuda.empty_cache()
    cfg = multimodal_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda",
                           native_seq_lens={"vision": VISION_PATCHES})
    trainer = Trainer(model, cfg, MM_LOSS_WEIGHTS, seed=SEED)
    state = trainer.init_state()
    start = copy.deepcopy(model.state_dict())
    batches = [make_mm_batch(gen, MM_BATCH) for _ in range(TRAIN_STEPS)]

    # the main path: Trainer.fit, counted, with every plain version made to
    # raise
    kernels.reset_launch_counts()
    with plain_versions_refused():
        state, fit_metrics = trainer.fit(state, iter(batches), TRAIN_STEPS,
                                         log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    want = expected_launches(
        **{name: n * TRAIN_STEPS for name, n in MM_PER_STEP.items()})
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps {launches} "
                             f"!= {want}")
    for name, v in fit_metrics.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name} = {v}")

    cmp = train_kernel_vs_plain(trainer, model, start, batches)
    falls = loss_falls(trainer, model, start, cfg, batches[0])
    timing = train_timing(trainer, batches[0])
    st = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(4)
    breakdown, by_op = kernel_breakdown(
        lambda: trainer.train_step(st, batches[0], g), n_calls=2)
    print(f"[12 train slice multimodal, 576 patches] B={MM_BATCH}, masking "
          f"on, contrastive 0.1, fit {TRAIN_STEPS} steps: launches per step "
          f"{MM_PER_STEP}, no plain version reached (routes over the run: "
          + route_counts(launches, "vmem_attention_fwd", "vmem_attention_bwd")
          + ") | fit loss "
          f"{fit_metrics['loss/total']:.4f} | kernel vs plain path over "
          f"{TRAIN_STEPS} steps (loss, grad_norm): kernel "
          f"{cmp['runs']['kernel']}, plain {cmp['runs']['plain']}, rel diff "
          f"{cmp['rel']} (tol {TRAIN_TOL}), params max_abs "
          f"{cmp['param_err']:.3g} (tol {cmp['param_tol']:.3g}) | loss on one "
          f"batch at lr 1e-3: {falls[0][0]:.4f} -> {falls[-1][0]:.4f} in "
          f"{LOSS_FALL_STEPS} steps | step ms eager (CUDA events over 5 "
          "steps, order kernel, plain, kernel, plain): " + turns(timing)
          + f" | {MM_BATCH / timing['step_ms'] * 1e3:.0f} obs/s with the "
          f"kernels, {MM_BATCH / timing['plain_step_ms'] * 1e3:.0f} with the "
          f"plain versions | peak mem of the kernel path "
          f"{timing['peak_gib']:.2f} GiB | {card()}")
    print_breakdown(12, f"B={MM_BATCH} train step", "step", breakdown, by_op)
    return {"launches": launches}


def print_breakdown(phase, what, per, breakdown, by_op) -> None:
    print(f"[{phase} kernels by device time, {what}, ms per {per} "
          "(launches)] " + "; ".join(
              f"{name[:60]} {ms:.4f} ({cnt:.0f})"
              for name, ms, cnt in breakdown[:25])
          + f" | total {sum(r[1] for r in breakdown):.3f} ms in "
          f"{sum(r[2] for r in breakdown):.0f} launches")
    print(f"[{phase} torch ops by the device time of their kernels, {what}, "
          f"ms per {per} (calls)] " + "; ".join(
              f"{name} {ms:.4f} ({cnt:.0f})" for name, ms, cnt in by_op[:20]))


def phase_clip(gen) -> dict:
    torch.cuda.empty_cache()
    cfg = multimodal_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda",
                           native_seq_lens={"vision": CLIP_PATCHES})
    trainer = Trainer(model, cfg, MM_LOSS_WEIGHTS, seed=SEED)
    start = copy.deepcopy(model.state_dict())
    requests = [make_mm_batch(gen, n, CLIP_PATCHES)
                for n in CLIP_REQUEST_SIZES]
    train_batches = [make_mm_batch(gen, CLIP_BATCH, CLIP_PATCHES)
                     for _ in range(2)]

    # the main paths, counted together with every plain version made to
    # raise: requests of 1 and 16 observations, then Trainer.fit at B=64
    kernels.reset_launch_counts()
    model.eval()
    with plain_versions_refused():
        with torch.inference_mode():
            for batch in requests:
                before = dict(kernels.launch_counts)
                out = model(batch)
                got = {k: kernels.launch_counts[k] - before[k]
                       for k in before}
                if got != expected_launches(**CLIP_PER_FORWARD):
                    raise AssertionError(f"launches per request {got}")
                n = batch["xyzt"].shape[0]
                if (tuple(out["fused_representation"].shape) != (n, 512)
                        or not bool(out["fused_representation"].isfinite()
                                    .all())):
                    raise AssertionError(f"B={n}: features not finite")
        before = dict(kernels.launch_counts)
        state, fit_metrics = trainer.fit(trainer.init_state(),
                                         iter(train_batches), 2, log_every=2)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    got = {k: launches[k] - before[k] for k in before}
    if got != expected_launches(**{k: 2 * n for k, n in
                                   CLIP_PER_STEP.items()}):
        raise AssertionError(f"launches over 2 train steps {got}")
    if not math.isfinite(fit_metrics["loss/total"]):
        raise AssertionError(f"loss {fit_metrics['loss/total']}")

    # kernel vs plain at CLIP_PLAIN_BATCH: a forward, and 3 train steps
    small = [make_mm_batch(gen, CLIP_PLAIN_BATCH, CLIP_PATCHES)
             for _ in range(TRAIN_STEPS)]
    model.load_state_dict(start)
    model.eval()
    with torch.inference_mode():
        out = model(small[0])
        with plain_versions():
            fwd_diff = output_diff(out, model(small[0]))
    del out
    if any(fwd_diff[k] > MM_SLICE_TOL[k] for k in MM_SLICE_TOL):
        raise AssertionError(f"kernel vs plain forward: {fwd_diff}")
    cmp = train_kernel_vs_plain(trainer, model, start, small,
                                tol=CLIP_TRAIN_TOL)

    # times: the train step at B=64 (the plain path's fp32 scores would
    # take 43 GB there) and at CLIP_PLAIN_BATCH against the plain path, the
    # forward of each request
    timing = train_timing(trainer, train_batches[0], iters=3, plain=False)
    small_timing = train_timing(trainer, small[0], iters=3)
    st = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(4)
    breakdown, by_op = kernel_breakdown(
        lambda: trainer.train_step(st, train_batches[0], g), n_calls=1)
    model.eval()
    serve = {}
    with torch.inference_mode():
        for batch in requests:
            n = batch["xyzt"].shape[0]
            walls = sorted(host_ms(lambda: model.extract_features(batch),
                                   iters=5))
            serve[n] = {"host_median_ms": walls[len(walls) // 2],
                        "device_ms": cuda_ms(
                            lambda: model.extract_features(batch), iters=5,
                            warmup=1)}
    print(f"[13 multimodal at {CLIP_PATCHES} patches] requests "
          f"{CLIP_REQUEST_SIZES}: launches per forward {CLIP_PER_FORWARD}; "
          f"fit 2 steps at B={CLIP_BATCH}: launches per step "
          f"{CLIP_PER_STEP}; no plain version reached; routes over the run "
          f"({route_counts(launches, 'flash_attention_bwd')}) | fit loss "
          f"{fit_metrics['loss/total']:.4f} | kernel vs plain at "
          f"B={CLIP_PLAIN_BATCH}: forward max {fwd_diff['max_abs']:.4g} mean "
          f"{fwd_diff['mean_abs']:.3g} (tol {MM_SLICE_TOL}); {TRAIN_STEPS} "
          f"train steps (loss, grad_norm) kernel {cmp['runs']['kernel']}, "
          f"plain {cmp['runs']['plain']}, rel diff {cmp['rel']} (tol "
          f"{CLIP_TRAIN_TOL}), params max_abs {cmp['param_err']:.3g} (tol "
          f"{cmp['param_tol']:.3g}) | train step ms eager (CUDA events over "
          f"3 steps): B={CLIP_BATCH} {turns(timing)}, "
          f"{CLIP_BATCH / timing['step_ms'] * 1e3:.1f} obs/s, peak mem "
          f"{timing['peak_gib']:.2f} GiB; B={CLIP_PLAIN_BATCH} "
          f"{turns(small_timing)} (peak mem of the kernel path "
          f"{small_timing['peak_gib']:.2f} GiB) | per request, host wall median and CUDA-event ms: "
          + ", ".join(f"B={n} {s['host_median_ms']:.3f}, {s['device_ms']:.3f}"
                      for n, s in serve.items())
          + f" | {card()}")
    print_breakdown(13, f"B={CLIP_BATCH} train step", "step", breakdown,
                    by_op)
    return {"launches": launches}


def gmm_case(gen, sizes, k, n, dtype, m=None):
    """lhs (M, K), rhs (E, K, N) and the sizes on the card; M defaults to
    the sum of the sizes."""
    sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    m = int(sizes.sum()) if m is None else m
    lhs = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    rhs = torch.randn((len(sizes), k, n), generator=gen, device="cuda").to(
        dtype)
    return lhs, rhs, sizes


def check_gmm(name, out, ref, dtype) -> tuple:
    """K5's output against its plain version's (K5_FP32_REL in fp32, K4's
    relative limits in bf16). Returns the largest error and the mean error
    over the mean |plain|."""
    if out.shape != ref.shape or out.dtype != torch.float32:
        raise AssertionError(f"K5 {name}: {out.shape} {out.dtype}")
    err = (out - ref).abs()
    top = ref.abs()
    rel = K5_FP32_REL if dtype == torch.float32 else K4_MAX_REL
    tol = rel * top.max().item() + 1e-6
    mean_rel = err.mean().item() / max(top.mean().item(), 1e-30)
    if not (err.max().item() <= tol and mean_rel <= K4_MEAN_REL):
        raise AssertionError(f"K5 {name}: max_abs_err {err.max().item()} "
                             f"(tol {tol}), mean over mean |plain| {mean_rel}"
                             f" (tol {K4_MEAN_REL})")
    return err.max().item(), mean_rel


def flagship_group_sizes(gen, n_tokens: int = 64 * FLAGSHIP_TOKENS,
                         k: int = 2, e: int = 8) -> list:
    """Expert loads of a top-2 choice over 8 experts for the simulator's
    tokens at B=64: each token's two distinct experts drawn at random."""
    scores = torch.rand((n_tokens, e), generator=gen, device="cuda")
    chosen = scores.topk(k, dim=-1).indices.reshape(-1)
    return torch.bincount(chosen, minlength=e).tolist()


def fwd_route(dtype, m, k, n) -> str:
    """The suffix of the K5-fwd counter these shapes launch."""
    if kernels.gmm_fwd_tma_route(dtype, m, k, n):
        return ""
    return "_mma" if dtype == torch.bfloat16 else "_fp32"


def phase_gmm(gen) -> dict:
    torch.cuda.empty_cache()
    errs, means, routes = {}, {}, {}
    flagship = flagship_group_sizes(gen)
    cases = {  # name: (group sizes, K, N, M or None for their sum)
        f"flagship 2816 E8 2048x2048 {flagship}": (flagship, 2048, 2048,
                                                   None),
        "empty groups, tiles across groups": ([0, 70, 0, 130, 100, 0], 96,
                                              200, None),
        "groups of 1-3 rows, a tile ending mid-group": (
            [1, 2, 3, 1, 130, 2, 0, 3], 64, 136, None),
        "K=8 N=8": ([5, 9, 3], 8, 8, None),
        "M=1": ([0, 1, 0, 0], 64, 64, None),
        "K=100 N=130 (2-element loads)": ([100, 57, 100], 100, 130, None),
        "K=33 N=31 (1-element loads)": ([5, 40, 19], 33, 31, None),
        "rows past the last group are 0": ([30, 20], 64, 128, 100),
    }
    route_launches = collections.Counter()
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (sizes, k, n, m) in cases.items():
            lhs, rhs, gs = gmm_case(gen, sizes, k, n, dtype, m)
            route = fwd_route(dtype, lhs.shape[0], k, n)
            key = f"{name} {tag}"
            kernels.reset_launch_counts()
            out = kernels.grouped_matmul_fwd(lhs, rhs, gs)
            want = expected_launches(**{f"grouped_matmul_fwd{route}": 1})
            if kernels.launch_counts != want:
                raise AssertionError(f"K5 {key}: launches "
                                     f"{kernels.launch_counts} != {want}")
            route_launches.update({k: v for k, v in
                                   kernels.launch_counts.items() if v})
            routes[key] = route or "TMA"
            ref = grouped_matmul.gmm_plain(lhs, rhs, gs)
            errs[key], means[key] = check_gmm(name, out, ref, dtype)
            if m is not None and not bool((out[sum(sizes):] == 0).all()):
                raise AssertionError(f"K5 {name}: rows past the groups")
            if not torch.equal(out, kernels.grouped_matmul_fwd(lhs, rhs, gs)):
                raise AssertionError(f"K5 {key}: two runs differ")
    kernels.reset_launch_counts()
    empty = kernels.grouped_matmul_fwd(*gmm_case(gen, [0, 0], 64, 64,
                                                 torch.bfloat16))
    if empty.shape != (0, 64) or any(kernels.launch_counts.values()):
        raise AssertionError("K5: M = 0 launched a kernel")

    # the flagship shape in bf16: kernel, the mma.sync route's kernel (the
    # earlier design), plain, library grouped matmuls (fp32 out: the same
    # work, where this torch takes it; bf16 out, the earlier yardstick),
    # and the bound (the weights of the groups with rows, lhs
    # and the sizes read once, the fp32 output written once)
    lhs, rhs, gs = gmm_case(gen, flagship, 2048, 2048, torch.bfloat16)
    bounds = [0] + torch.cumsum(gs, dim=0).tolist()
    library_name, library_call = grouped_mm_call(lhs, rhs, bounds, "rows")
    fp32_name, fp32_call = grouped_mm_call(lhs, rhs, bounds, "rows",
                                           out_dtype=torch.float32)
    t = {"ms": cuda_ms(lambda: kernels.grouped_matmul_fwd(lhs, rhs, gs),
                       iters=50, warmup=5),
         "mma_ms": cuda_ms(lambda: kernels.grouped_matmul_fwd_mma(lhs, rhs,
                                                                  gs),
                           iters=20, warmup=3),
         "plain_ms": cuda_ms(lambda: grouped_matmul.gmm_plain(lhs, rhs, gs),
                             iters=10, warmup=2),
         "library_ms": cuda_ms(library_call, iters=50, warmup=5),
         "fp32_library_ms": (cuda_ms(fp32_call, iters=50, warmup=5)
                             if fp32_name == library_name else None)}
    used = sum(1 for s in flagship if s > 0)
    flops = 2 * lhs.shape[0] * 2048 * 2048
    t.update(bound(nbytes(lhs, gs) + used * 2048 * 2048 * 2
                   + lhs.shape[0] * 2048 * 4, flops, torch.bfloat16))
    t["tflops"] = flops / t["ms"] / 1e9
    tma_err, mma_err = (max(v for k, v in errs.items() if routes[k] == r)
                        for r in ("TMA", "_mma"))
    print("[14 K5 grouped_matmul_fwd] routes per case (TMA = wgmma over TMA "
          "tiles, _mma, _fp32): " + ", ".join(
              f"{k} {v}" for k, v in routes.items())
          + " | max_abs_err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol fp32 {K5_FP32_REL}, bf16 {K4_MAX_REL} of the largest "
          "entry) | mean error over mean |plain| " + ", ".join(
              f"{k} {v:.3g}" for k, v in means.items())
          + f" (tol {K4_MEAN_REL}) | two runs of each case bitwise equal, "
          "rows past the groups 0, M=0 launches nothing | ms at the flagship "
          "simulator's B=64 shape, bf16 (device, CUDA events): kernel "
          f"{t['ms']:.4f} ({t['tflops']:.1f} TFLOP/s), mma.sync route's "
          f"kernel {t['mma_ms']:.4f}, plain {t['plain_ms']:.4f}, library "
          f"({library_name}, bf16 out) {t['library_ms']:.4f}, library "
          f"({fp32_name}, fp32 out: the same work) "
          + (f"{t['fp32_library_ms']:.4f}" if t["fp32_library_ms"]
             is not None else "not taken by this torch")
          + f", bound {t['bound_ms']:.4f} ({t['bound_by']}) | {card()}")
    return {"max_abs_err": tma_err, "mma_max_abs_err": mma_err,
            "library": library_name, "launches": dict(route_launches), **t}


def check_gmm_bwd(name, got, ref, dtype) -> tuple:
    """K5-bwd's (dlhs, drhs) against gmm_bwd_plain's: each within
    K5_FP32_REL (fp32) or K4_MAX_REL (bf16) of its largest entry, the mean
    error within K4_MEAN_REL of the mean |plain|, and in bf16 at least
    K5_BWD_MIN_EQUAL of the entries equal. Returns the largest error, the
    largest mean error over the mean |plain| and the smallest equal share
    (1 in fp32, where the sums' order alone differs)."""
    errs, means, shares = [], [], []
    for part, out, r in zip(("dlhs", "drhs"), got, ref):
        if out.shape != r.shape or out.dtype != dtype:
            raise AssertionError(f"K5-bwd {name} {part}: {out.shape} "
                                 f"{out.dtype}")
        if out.numel() == 0:
            continue
        err = (out.float() - r.float()).abs()
        top = r.float().abs()
        rel = K5_FP32_REL if dtype == torch.float32 else K4_MAX_REL
        tol = rel * top.max().item() + 1e-6
        mean_rel = err.mean().item() / max(top.mean().item(), 1e-30)
        share = (1.0 if dtype == torch.float32
                 else (out == r).float().mean().item())
        if not (err.max().item() <= tol and mean_rel <= K4_MEAN_REL
                and share >= K5_BWD_MIN_EQUAL):
            raise AssertionError(
                f"K5-bwd {name} {part}: max_abs_err {err.max().item()} (tol "
                f"{tol}), mean over mean |plain| {mean_rel} (tol "
                f"{K4_MEAN_REL}), equal share {share} (at least "
                f"{K5_BWD_MIN_EQUAL})")
        errs.append(err.max().item())
        means.append(mean_rel)
        shares.append(share)
    return max(errs, default=0.0), max(means, default=0.0), min(shares,
                                                                default=1.0)


def grouped_mm_call(a, b, bounds, over, out_dtype=None):
    """(name, call) of one PyTorch grouped matmul over the segments
    ``bounds`` (offsets, 0 first) of a's rows (``over`` "rows": a (M, R) by
    b (E, R, N), as K5-fwd and dlhs) or of the reduction ("reduction": a
    (K, M) by b (M, N), as drhs), a yardstick only: torch._grouped_mm where
    this torch has it and takes the inputs (with ``out_dtype`` where given),
    else one torch.mm per segment."""
    offs = torch.tensor(bounds[1:], dtype=torch.int32, device=a.device)
    segments = [(g, bounds[g], bounds[g + 1]) for g in range(len(bounds) - 1)
                if bounds[g + 1] > bounds[g]]
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(a, b, offs=offs, **kw)
            return "torch._grouped_mm", lambda: torch._grouped_mm(
                a, b, offs=offs, **kw)
        except (RuntimeError, TypeError, NotImplementedError):
            pass
    if over == "rows":
        return "torch.mm per group", lambda: [
            torch.mm(a[s:e], b[g]) for g, s, e in segments]
    return "torch.mm per group", lambda: [
        torch.mm(a[:, s:e], b[s:e]) for g, s, e in segments]


def library_gmm_bwd(lhs, rhs, dout, sizes) -> dict:
    """Two PyTorch yardsticks per gradient on the same inputs, arranged
    outside any timed region: {"rounded": {part: (name, call)}, "split":
    {...}}. "rounded" multiplies dout rounded to bf16 (half K5-bwd's work,
    a coarser result); "split" does K5-bwd's work, hi and lo (dout's split)
    summed in one product: dlhs as [hi | lo] (M, 2N) by [rhs^T ; rhs^T],
    drhs as each group's lhs rows taken twice by its hi and lo rows, the
    offsets doubled."""
    bounds = [0] + torch.cumsum(sizes, dim=0).tolist()
    d16 = dout.to(lhs.dtype)
    hi, lo = grouped_matmul.split_dout_plain(dout)
    out = {"rounded": {
        "dlhs": grouped_mm_call(d16, rhs.transpose(1, 2), bounds, "rows"),
        "drhs": grouped_mm_call(lhs.t(), d16, bounds, "reduction")}}
    m = lhs.shape[0]
    rows = torch.cat([torch.arange(s, e, device=lhs.device).repeat(2)
                      for s, e in zip(bounds, bounds[1:])])
    parts_rows = torch.cat([torch.cat([torch.arange(s, e), m + torch.arange(
        s, e)]) for s, e in zip(bounds, bounds[1:])]).to(lhs.device)
    out["split"] = {
        "dlhs": grouped_mm_call(torch.cat([hi, lo], dim=1),
                                torch.cat([rhs, rhs], dim=2).transpose(1, 2),
                                bounds, "rows"),
        "drhs": grouped_mm_call(lhs[rows].t(),
                                torch.cat([hi, lo])[parts_rows],
                                [2 * b for b in bounds], "reduction")}
    return out


def bwd_route(dtype, m, k, n) -> str:
    """The suffix of the K5-bwd counter these shapes launch."""
    if kernels.gmm_bwd_tma_route(dtype, m, k, n):
        return ""
    return "_mma" if dtype == torch.bfloat16 else "_fp32"


def phase_gmm_bwd(gen) -> dict:
    torch.cuda.empty_cache()
    errs, means, shares, routes = {}, {}, {}, collections.Counter()
    route_err, route_launches = collections.Counter(), collections.Counter()
    flagship = flagship_group_sizes(gen)
    cases = {  # name: (group sizes, K, N, M or None for their sum)
        f"flagship 2816 E8 2048x2048 {flagship}": (flagship, 2048, 2048,
                                                   None),
        "empty groups, tiles across groups": ([0, 70, 0, 130, 100, 0], 96,
                                              200, None),
        "K=136 N=88, groups of 64 and 1 row": ([64, 1, 0, 129, 191], 136, 88,
                                               None),
        "M=1": ([0, 1, 0, 0], 64, 64, None),
        "K=100 N=130 (2-element loads)": ([100, 57, 100], 100, 130, None),
        "K=33 N=31 (1-element loads)": ([5, 40, 19], 33, 31, None),
        "rows past the last group": ([30, 20], 64, 128, 100),
        "M=0": ([0, 0, 0], 64, 64, None),
    }
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (sizes, k, n, m) in cases.items():
            lhs, rhs, gs = gmm_case(gen, sizes, k, n, dtype, m)
            # fp32 dout with genuine low bits, as the gate and up products'
            # gradients are
            dout = torch.randn((lhs.shape[0], n), generator=gen,
                               device="cuda")
            route = bwd_route(dtype, lhs.shape[0], k, n)
            key = f"{name} {tag}"
            # as autograd calls it: the TMA route's split made once
            kernels.reset_launch_counts()
            got = kernels.grouped_matmul_bwd(lhs, rhs, gs, dout)
            want = expected_launches(**{
                "grouped_matmul_split_dout": int(route == ""),
                f"grouped_matmul_bwd_dlhs{route}": int(lhs.shape[0] > 0),
                f"grouped_matmul_bwd_drhs{route}": 1})
            if kernels.launch_counts != want:
                raise AssertionError(f"K5-bwd {key}: launches "
                                     f"{kernels.launch_counts} != {want}")
            routes[route or "_tma"] += 1
            route_launches.update({k: v for k, v in
                                   kernels.launch_counts.items() if v})
            if route == "":
                parts = kernels.grouped_matmul_split_dout(dout)
                plain = grouped_matmul.split_dout_plain(dout)
                if not all(torch.equal(a, b) for a, b in zip(parts, plain)):
                    raise AssertionError(f"K5-bwd split {key}: not bitwise "
                                         "equal to split_dout_plain")
                del parts, plain
            ref = grouped_matmul.gmm_bwd_plain(lhs, rhs, gs, dout)
            errs[key], means[key], shares[key] = check_gmm_bwd(
                key, got, ref, dtype)
            route_err[route] = max(route_err[route], errs[key])
            for g, size in enumerate(sizes):
                if size == 0 and not bool((got[1][g] == 0).all()):
                    raise AssertionError(f"K5-bwd {key}: empty group {g}'s "
                                         "drhs is not 0")
            if m is not None and not bool((got[0][sum(sizes):] == 0).all()):
                raise AssertionError(f"K5-bwd {key}: rows past the groups")
            again = kernels.grouped_matmul_bwd(lhs, rhs, gs, dout)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K5-bwd {key}: two runs differ")
            del lhs, rhs, gs, dout, got, ref, again
    kernels.reset_launch_counts()

    # the flagship shape in bf16: the split, each kernel given the split,
    # the mma.sync route's kernel (the earlier design), the plain version,
    # two library yardsticks, and the bound (each input read once: dout or
    # its parts, the weights of the groups with rows or lhs; each output
    # written once: the parts, dlhs, or every group's drhs; the tensor
    # cores' operations twice, hi and lo)
    lhs, rhs, gs = gmm_case(gen, flagship, 2048, 2048, torch.bfloat16)
    dout = torch.randn((lhs.shape[0], 2048), generator=gen, device="cuda")
    # what rounding dout to bf16 before the product would have given
    ref = grouped_matmul.gmm_bwd_plain(lhs, rhs, gs, dout)
    rounded = grouped_matmul.gmm_bwd_plain(lhs, rhs, gs, dout.bfloat16())
    rounded_share = min((a == b).float().mean().item()
                        for a, b in zip(rounded, ref))
    del ref, rounded
    library = library_gmm_bwd(lhs, rhs, dout, gs)
    parts = kernels.grouped_matmul_split_dout(dout)
    m, used = lhs.shape[0], sum(1 for x in flagship if x > 0)
    flops = 2 * m * 2048 * 2048
    mma = {  # the mma.sync kernels: a yardstick here
        "dlhs": lambda: kernels.grouped_matmul_bwd_dlhs_mma(dout, rhs, gs),
        "drhs": lambda: kernels.grouped_matmul_bwd_drhs_mma(lhs, dout, gs)}
    parts_of = {
        "dlhs": (lambda: kernels.grouped_matmul_bwd_dlhs_tma(*parts, rhs, gs),
                 lambda: grouped_matmul.gmm_bwd_plain(lhs, rhs, gs, dout,
                                                      need_rhs=False),
                 nbytes(dout, gs) + used * 2048 * 2048 * 2 + m * 2048 * 2),
        "drhs": (lambda: kernels.grouped_matmul_bwd_drhs_tma(lhs, *parts, gs),
                 lambda: grouped_matmul.gmm_bwd_plain(lhs, rhs, gs, dout,
                                                      need_lhs=False),
                 nbytes(lhs, dout, gs) + nbytes(rhs)),
    }
    times = {}
    for part, (kernel, plain, moved) in parts_of.items():
        t = {"ms": cuda_ms(kernel, iters=50, warmup=5),
             "mma_ms": cuda_ms(mma[part], iters=20, warmup=3),
             "plain_ms": cuda_ms(plain, iters=10, warmup=2)}
        t["library"], split_call = library["split"][part]
        t["library_ms"] = cuda_ms(split_call, iters=20, warmup=3)
        t["rounded_library"], rounded_call = library["rounded"][part]
        t["rounded_library_ms"] = cuda_ms(rounded_call, iters=20, warmup=3)
        t.update(bound(moved, 2 * flops, torch.bfloat16))
        t["once_bound_ms"] = bound(moved, flops, torch.bfloat16)["bound_ms"]
        t["tflops"] = 2 * flops / t["ms"] / 1e9
        times[part] = t
    split_plain = grouped_matmul.split_dout_plain(dout)
    split = {"ms": graph_ms(lambda: kernels.grouped_matmul_split_dout(dout)),
             "plain_ms": graph_ms(
                 lambda: grouped_matmul.split_dout_plain(dout)),
             "library_ms": None,
             "max_abs_err": max(max_err(a, b) for a, b in
                                zip(parts, split_plain)),
             **bound(nbytes(dout) + nbytes(*parts), 0, torch.bfloat16)}
    del split_plain
    total = split["ms"] + times["dlhs"]["ms"] + times["drhs"]["ms"]
    print("[14 K5-bwd grouped_matmul_split_dout + grouped_matmul_bwd_dlhs/"
          "drhs] routes per case (TMA = wgmma over TMA tiles, _mma, _fp32): "
          + ", ".join(f"{k} {v}" for k, v in sorted(routes.items()))
          + " | max_abs_err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol fp32 {K5_FP32_REL}, bf16 {K4_MAX_REL} of the largest "
          "entry) | mean error over mean |plain| " + ", ".join(
              f"{k} {v:.3g}" for k, v in means.items())
          + f" (tol {K4_MEAN_REL}) | bf16 entries equal to the plain "
          "version's: " + ", ".join(
              f"{k} {v:.5f}" for k, v in shares.items() if "bfloat16" in k)
          + f" (at least {K5_BWD_MIN_EQUAL}; dout rounded to bf16 first would "
          f"give {rounded_share:.4f} at the flagship shape) | split bitwise "
          "equal to split_dout_plain, two runs of each case bitwise equal, "
          "empty groups' drhs exactly 0, rows past the groups 0, M=0 "
          "launches dlhs nothing | ms at the flagship simulator's B=64 "
          "shape, bf16 lhs/rhs, fp32 dout (device, CUDA events; the split "
          f"CUDA-graph replays): split {split['ms']:.4f} (plain "
          f"{split['plain_ms']:.4f}, bound {split['bound_ms']:.4f} bytes); "
          + "; ".join(
              f"{part} kernel {t['ms']:.4f} ({t['tflops']:.1f} TFLOP/s "
              f"counting hi and lo), mma.sync route's kernel {t['mma_ms']:.4f}"
              f", plain {t['plain_ms']:.4f}, library ({t['library']}, hi + "
              f"lo: the same work) {t['library_ms']:.4f}, library "
              f"({t['rounded_library']}, dout in bf16: half the work) "
              f"{t['rounded_library_ms']:.4f}, bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}, operations counted twice; once-counted "
              f"{t['once_bound_ms']:.4f})" for part, t in times.items())
          + f"; K5-bwd (split + dlhs + drhs) {total:.4f} | {card()}")
    del lhs, rhs, gs, dout, parts, library
    return {"split": split, "launches": dict(route_launches), **{
        part: {"max_abs_err": route_err[""], "mma_max_abs_err":
               route_err["_mma"], **t} for part, t in times.items()}}


def make_flagship_batch(gen, n, patches=CLIP_PATCHES):
    """One request of the flagship: n observations, each with a place and
    time, V-JEPA2 patch embeddings of 1408 (a clip's 4608 by default, an
    image's 576) and 16 language rows of 7168, in bf16
    (tools/bench_flagship.py's inputs)."""
    dev = gen.device
    return {
        "xyzt": torch.rand((n, 4), generator=gen, device=dev),
        "modalities": {
            "vision": torch.randn((n, patches, 1408), generator=gen,
                                  device=dev).to(torch.bfloat16),
            "language": torch.randn((n, 16, 7168), generator=gen,
                                    device=dev).to(torch.bfloat16),
        },
    }


def moe_sites(model) -> dict:
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, MoELayer)}


def site_modes(model) -> dict:
    """The dispatch mode each MoE site took in the last forward; the
    simulator's layers as one entry, counted."""
    modes = {}
    for name, mod in moe_sites(model).items():
        key = "simulator" if name.startswith("simulator.") else name
        modes.setdefault(key, []).append(mod.mode)
    return {k: (v[0] if len(v) == 1 else
                ", ".join(f"{m} x{v.count(m)}" for m in sorted(set(v))))
            for k, v in modes.items()}


@contextlib.contextmanager
def gate_log(pinned: Optional[list] = None):
    """Log every MoE gate's top-k choice made inside, in call order. With
    ``pinned``, the log of an earlier run, each call routes as that run did
    (its weights from this run's own scores), and the log keeps this run's
    own choice: the difference between two runs is then their arithmetic,
    and a flipped near-tie is counted, not propagated."""
    real, log = moe.moe_gate, []

    def gate(logits, bias, **kw):
        g = real(logits, bias, **kw)
        log.append(g.topk_idx)
        if pinned is None:
            return g
        idx = pinned[len(log) - 1]
        w = torch.gather(g.scores, 1, idx.long())
        if kw["top_k"] > 1 and kw["norm_topk_prob"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return moe.GateResult(idx, w * kw["routed_scaling_factor"], g.scores)
    with mock.patch.object(moe, "moe_gate", gate):
        yield log


def flipped_shares(names, a: list, b: list) -> dict:
    """Per MoE site (in call order), the share of tokens whose expert set
    differs between two gate logs."""
    if len(a) != len(names) or len(b) != len(names):
        raise AssertionError(f"{len(a)} and {len(b)} gate calls for "
                             f"{len(names)} MoE sites")
    return {n: (x.sort(dim=-1).values != y.sort(dim=-1).values).any(dim=-1)
            .float().mean().item() for n, x, y in zip(names, a, b)}


@contextlib.contextmanager
def simulator_mode(model, mode: str):
    """Force the simulator's MoE layers to one dispatch mode inside."""
    layers = [m for n, m in moe_sites(model).items()
              if n.startswith("simulator.")]
    saved = [m.cfg for m in layers]
    for m in layers:
        m.cfg = dataclasses.replace(m.cfg, dispatch_mode=mode)
    try:
        yield
    finally:
        for m, cfg in zip(layers, saved):
            m.cfg = cfg


def phase_flagship(gen) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    cfg = integrated_config(use_deepseek_fusion=True,
                            param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = DeepEarthModel(cfg, generator=gen, device=gen.device,
                           native_seq_lens={"vision": CLIP_PATCHES,
                                            "language": 16}).eval()
    D = cfg.fusion.universal_dim
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    requests = [make_flagship_batch(gen, n) for n in FLAGSHIP_REQUEST_SIZES]

    # the main path: requests through the user's entry points, counted, with
    # every plain version made to raise
    kernels.reset_launch_counts()
    modes, counted = {}, {}
    with torch.inference_mode(), plain_versions_refused():
        for batch in requests:
            n = batch["xyzt"].shape[0]
            before = dict(kernels.launch_counts)
            out = model(batch)
            feats = model.extract_features(batch)
            got = {k: kernels.launch_counts[k] - before[k] for k in before}
            per_forward = {**FLAGSHIP_PER_FORWARD,
                           "grouped_matmul_fwd": K5_PER_FORWARD[n]}
            want = expected_launches(**{k: 2 * v for k, v in
                                        per_forward.items()})
            if got != want:
                raise AssertionError(f"B={n}: launches per request {got} != "
                                     f"{want}")
            if not torch.equal(feats, out["fused_representation"]):
                raise AssertionError("extract_features != forward")
            shapes = {"fused_representation": (n, D),
                      "all_tokens": (n, FLAGSHIP_TOKENS, D),
                      "spatial": (n, 3), "temporal": (n, 1),
                      "vision": (n, 1408), "language": (n, 7168)}
            outs = {"fused_representation": out["fused_representation"],
                    "all_tokens": out["all_tokens"], **out["reconstructions"]}
            for key, shape in shapes.items():
                if tuple(outs[key].shape) != shape or not bool(
                        outs[key].isfinite().all()):
                    raise AssertionError(f"B={n} {key}: shape "
                                         f"{tuple(outs[key].shape)} or "
                                         "non-finite values")
            modes[n] = site_modes(model)
            counted[n] = {k: v for k, v in got.items() if v}
            del out, feats, outs
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)

    # per request: host wall time, CUDA-event time, peak memory
    timing = {}
    with torch.inference_mode():
        for batch in requests:
            n = batch["xyzt"].shape[0]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            walls = sorted(host_ms(lambda: model.extract_features(batch),
                                   iters=5))
            timing[n] = {
                "host_median_ms": walls[len(walls) // 2],
                "host_max_ms": walls[-1],
                "device_ms": cuda_ms(lambda: model.extract_features(batch),
                                     iters=3, warmup=1),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        big = requests[-1]
        breakdown, by_op = kernel_breakdown(
            lambda: model.extract_features(big), n_calls=1)

    # kernel vs plain, the plain run routed as the kernel run was: the
    # simulator alone at B=64 on one fusion output (K5 against its plain
    # version), then the whole model at FLAGSHIP_PLAIN_BATCH with the
    # simulator forced ragged (K4, K5 and K2 against their plain versions)
    fused = {}
    hook = model.fusion.register_forward_hook(
        lambda mod, args, out: fused.update(h=out["all_tokens"]))
    sites = list(moe_sites(model))
    with torch.inference_mode():
        model(big)
        hook.remove()
        with gate_log() as log_k:
            sim_k = model.simulator(fused["h"])
        with gate_log(log_k) as log_p, plain_versions():
            sim_p = model.simulator(fused["h"])
        sim_shares = flipped_shares(
            [n for n in sites if n.startswith("simulator.")], log_k, log_p)
        diffs = {"simulator B=64": output_diff(
            {"fused_representation": sim_k, "reconstructions": {}},
            {"fused_representation": sim_p, "reconstructions": {}})}
        del sim_k, sim_p, fused
        small = make_flagship_batch(gen, FLAGSHIP_PLAIN_BATCH)
        with simulator_mode(model, "ragged"):
            kernels.reset_launch_counts()
            with gate_log() as log_k:
                out_k = model(small)
            k5_small = kernels.launch_counts["grouped_matmul_fwd"]
            torch.cuda.empty_cache()
            with gate_log(log_k) as log_p, plain_versions():
                out_p = model(small)
        shares = flipped_shares(sites, log_k, log_p)
        diffs[f"model B={FLAGSHIP_PLAIN_BATCH}"] = output_diff(out_k, out_p)
        del out_k, out_p
    if k5_small != K5_PER_RAGGED_FORWARD:
        raise AssertionError(f"the ragged B={FLAGSHIP_PLAIN_BATCH} forward "
                             f"launched K5 {k5_small} times")

    def worst(shares):
        return (f"mean {sum(shares.values()) / len(shares):.3g}, by site in "
                "call order " + " ".join(f"{v:.3g}" for v in shares.values()))
    print(f"[15 flagship serving] {n_params / 1e9:.4f}B params (bf16), "
          f"built in {build_s:.1f} s | requests {FLAGSHIP_REQUEST_SIZES} "
          f"finite; launches per request (forward and extract_features) "
          f"{counted}, as expected: per forward K4-fwd 2, K2-fwd 2, K5 "
          f"{K5_PER_RAGGED_FORWARD} at B=64 and 0 at B <= 16 (the simulator "
          "dense there); no plain version reached; routes over the run "
          f"({route_counts(launches, 'grouped_matmul_fwd')}) | dispatch modes: "
          + "; ".join(f"B={n} " + ", ".join(f"{k} {v}" for k, v in m.items())
                      for n, m in modes.items())
          + " | per request, host wall median/max, CUDA-event ms, peak mem, "
          "obs/s: " + ", ".join(
              f"B={n} {t['host_median_ms']:.2f}/{t['host_max_ms']:.2f}, "
              f"{t['device_ms']:.2f}, {t['peak_gib']:.2f} GiB, "
              f"{n / t['device_ms'] * 1e3:.1f}" for n, t in timing.items())
          + " | kernel vs plain, the plain run routed as the kernel run: "
          f"simulator alone at B=64 (its own routing would flip for tokens "
          f"{worst(sim_shares)}); the whole model at "
          f"B={FLAGSHIP_PLAIN_BATCH}, simulator ragged, K5 {k5_small} "
          f"launches (flips {worst(shares)}); outputs " + ", ".join(
              f"{k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
              for k, v in diffs.items())
          + f" (tol {FLAGSHIP_TOL}; flipped share at most "
          f"{FLAGSHIP_MAX_FLIPPED}) | {card()}")
    print_breakdown(15, "B=64 forward", "forward", breakdown, by_op)
    for name, d in diffs.items():
        if any(d[k] > FLAGSHIP_TOL[k] for k in FLAGSHIP_TOL):
            raise AssertionError(f"flagship kernel vs plain, {name}: {d} "
                                 f"(tol {FLAGSHIP_TOL})")
    for name, share in {**sim_shares, **shares}.items():
        if share > FLAGSHIP_MAX_FLIPPED:
            raise AssertionError(f"routing flipped for {share:.4f} of the "
                                 f"tokens at {name}")
    return {"launches": launches}


def flagship_train_config() -> DeepEarthConfig:
    """The flagship as tools/bench_flagship.py trains it: bf16 parameters
    and compute, the fused AdamW with a bf16 first moment and a factored
    second moment."""
    cfg = integrated_config(use_deepseek_fusion=True,
                            param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16)
    cfg.optimizer.moment_dtype = "bfloat16"
    cfg.optimizer.second_moment = "factored"
    cfg.optimizer.fused = True
    return cfg


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def flagship_generator() -> torch.Generator:
    """The generator phases 15 and 16 each draw from: their own, seeded
    from SEED, so that a draw added to an earlier phase does not move
    theirs."""
    return torch.Generator(device="cuda").manual_seed(SEED)


def gmm_plain_halves(lhs: torch.Tensor, rhs: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """gmm_plain with each group's product summed over K in two halves,
    then added: the same function with one summation order changed, a
    yardstick of how far the model carries rounding
    (--flagship-train-spread only)."""
    m, k = lhs.shape
    half = k // 2
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), m)
        if end > start:
            a, b = lhs[start:end].float(), rhs[g].float()
            out[start:end] = a[:, :half] @ b[:half] + a[:, half:] @ b[half:]
        start = end
    return out


def flagship_train_run(trainer, model, start, batches, pinned=None,
                       plain=False, plain_gmm=None):
    """TRAIN_STEPS train steps from the host state ``start`` with a fresh
    optimizer (the configured schedule) and the masks of one seed, with the
    kernels or through the plain versions (``plain_gmm``, if given, in
    place of gmm_plain); with ``pinned`` (a gate log) routed as that run
    was. Returns per-step (loss, aux term, grad norm), the gate log, the
    parameters after the last step (on the host) and the learning rates
    used."""
    model.load_state_dict(start)
    st = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(1)
    steps = []
    swap = (mock.patch.object(grouped_matmul, "gmm", plain_gmm)
            if plain_gmm is not None else contextlib.nullcontext())
    with gate_log(pinned) as log, (plain_versions() if plain
                                   else contextlib.nullcontext()), swap:
        for batch in batches:
            st, m = trainer.train_step(st, batch, g)
            steps.append(tuple(m[k].item() for k in
                               ("loss/total", "loss/moe_aux", "grad_norm")))
    params = {n: p.detach().to("cpu", copy=True)
              for n, p in model.named_parameters()}
    lrs = [st.optimizer.learning_rate(i) for i in range(len(batches))]
    del st
    model.zero_grad(set_to_none=True)
    free_cuda()
    return steps, log, params, lrs


def phase_flagship_train(gen) -> dict:
    free_cuda()
    cfg = flagship_train_config()
    t0 = time.perf_counter()
    model = DeepEarthModel(cfg, generator=gen, device=gen.device,
                           native_seq_lens={"vision": VISION_PATCHES,
                                            "language": 16})
    build_s = time.perf_counter() - t0
    trainer = Trainer(model, cfg, FLAGSHIP_TRAIN_WEIGHTS, seed=SEED)
    start = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}  # ~10 GB, on the host
    b = FLAGSHIP_TRAIN_BATCH
    batches = [make_flagship_batch(gen, b, VISION_PATCHES)
               for _ in range(TRAIN_STEPS)]

    # the main path: Trainer.fit, counted, with every plain version made to
    # raise
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with plain_versions_refused():
        state, fit_metrics = trainer.fit(trainer.init_state(), iter(batches),
                                         TRAIN_STEPS, log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(kernels.launch_counts)
    want = expected_launches(
        **{name: n * TRAIN_STEPS for name, n in FLAGSHIP_PER_STEP.items()})
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps {launches} "
                             f"!= {want}")
    modes = site_modes(model)
    if "loss/moe_aux" not in fit_metrics:
        raise AssertionError(f"no aux term in {sorted(fit_metrics)}")
    for name, v in fit_metrics.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name} = {v}")
    del state
    model.zero_grad(set_to_none=True)
    free_cuda()

    # kernel vs plain over TRAIN_STEPS steps from one start state, the plain
    # run routed as the kernel run was
    runs, logs, params = {}, {}, {}
    runs["kernel"], logs["kernel"], params["kernel"], lrs = \
        flagship_train_run(trainer, model, start, batches)
    runs["plain"], logs["plain"], params["plain"], _ = flagship_train_run(
        trainer, model, start, batches, pinned=logs["kernel"], plain=True)
    names = list(moe_sites(model))
    sites = [f"{name} step {i + 1}" for i in range(TRAIN_STEPS)
             for name in names]
    shares = flipped_shares(sites, logs["kernel"], logs["plain"])
    del logs
    rel = train_rel(runs["kernel"], runs["plain"])
    # Adam moves an element by at most ~lr a step, and a bf16 parameter
    # rounds its update to a neighbour: |kernel - plain| beyond one bf16
    # ulp of the parameter (2^-7 of it), against 3 * sum(lr)
    leaf_err = {n: ((params["kernel"][n].float() - params["plain"][n].float())
                    .abs() - 2 ** -7 * params["plain"][n].float().abs())
                .max().item() for n in params["plain"]}
    param_err, param_tol = max(leaf_err.values()), 3 * sum(lrs)
    worst_leaf = max(leaf_err, key=leaf_err.get)
    del params
    model.load_state_dict(start)
    del start
    free_cuda()

    # times: CUDA events over 3 steps after a warm-up step, peak memory, and
    # a per-op profile of one step
    timing = train_timing(trainer, batches[0], iters=3, plain=False)
    free_cuda()
    st = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(4)
    breakdown, by_op = kernel_breakdown(
        lambda: trainer.train_step(st, batches[0], g), n_calls=1)
    del st
    model.zero_grad(set_to_none=True)
    free_cuda()
    step_ms = sum(r[1] for r in breakdown)
    k5 = {part: sum(r[1] for r in breakdown if key in r[0])
          for part, key in (("fwd", "gmm_fwd_wgmma_kernel"),
                            ("split", "gmm_split_dout_kernel"),
                            ("dlhs", "gmm_dlhs_wgmma_kernel"),
                            ("drhs", "gmm_drhs_wgmma_kernel"))}
    print(f"[16 flagship train step] {sum(p.numel() for p in model.parameters()) / 1e9:.4f}B "
          f"params (bf16), built in {build_s:.1f} s | B={b}, {VISION_PATCHES} "
          f"patches, masking on, {FLAGSHIP_TRAIN_WEIGHTS}, bf16 first moment, "
          f"factored second moment; fit {TRAIN_STEPS} steps: launches per "
          f"step {FLAGSHIP_PER_STEP}, nothing else, no plain version reached "
          f"(routes over the run: "
          + route_counts(launches, "grouped_matmul_fwd",
                         "grouped_matmul_bwd_dlhs", "grouped_matmul_bwd_drhs",
                         "vmem_attention_fwd", "vmem_attention_bwd") + ") "
          f"| dispatch modes: " + ", ".join(f"{k} {v}" for k, v in
                                             modes.items())
          + f" | fit loss {fit_metrics['loss/total']:.4f}, moe_aux "
          f"{fit_metrics['loss/moe_aux']:.4f}, peak mem {fit_peak:.2f} GiB | "
          f"kernel vs plain over {TRAIN_STEPS} steps (lr {lrs}), the plain "
          f"run routed as the kernel run (loss, moe_aux, grad_norm): kernel "
          f"{runs['kernel']}, plain {runs['plain']}; rel diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tol {FLAGSHIP_TRAIN_TOL}); params beyond a bf16 ulp "
          f"{param_err:.3g} at {worst_leaf} (tol 3*sum(lr) = "
          f"{param_tol:.3g}); routing that would flip on its own, by step "
          "(mean, max over sites): " + ", ".join(
              f"{i + 1}: {sum(v) / len(v):.3g}, {max(v):.3g}" for i, v in
              enumerate([[shares[f'{n} step {i + 1}'] for n in names]
                         for i in range(TRAIN_STEPS)]))
          + f"; the largest: " + ", ".join(
              f"{k} {v:.3g}" for k, v in sorted(
                  shares.items(), key=lambda kv: -kv[1])[:4])
          + f" (tol {FLAGSHIP_MAX_FLIPPED}) | step ms "
          f"eager (CUDA events over 3 steps): {turns(timing)}, "
          f"{b / timing['step_ms'] * 1e3:.1f} obs/s, peak mem "
          f"{timing['peak_gib']:.2f} GiB | profiled step: {step_ms:.2f} ms of "
          f"kernels; K5-fwd {k5['fwd']:.2f} ms, K5-bwd split "
          f"{k5['split']:.2f}, dlhs {k5['dlhs']:.2f} and drhs "
          f"{k5['drhs']:.2f} ms (K5-bwd "
          f"{k5['split'] + k5['dlhs'] + k5['drhs']:.2f}), "
          f"{sum(k5.values()) / max(step_ms, 1e-9):.1%} of it | {card()}")
    print_breakdown(16, f"B={b} train step", "step", breakdown, by_op)
    if (any(rel[k] > FLAGSHIP_TRAIN_TOL[k] for k in FLAGSHIP_TRAIN_TOL)
            or param_err > param_tol):
        raise AssertionError(f"flagship kernel vs plain train path: {rel}, "
                             f"params {param_err} (tol {FLAGSHIP_TRAIN_TOL}"
                             f", params {param_tol})")
    for name, share in shares.items():
        if share > FLAGSHIP_MAX_FLIPPED:
            raise AssertionError(f"routing flipped for {share:.4f} of the "
                                 f"tokens at {name}")
    del model, trainer, batches
    free_cuda()
    return {"launches": launches}


def train_rel(kernel: list, plain: list) -> dict:
    """The largest per-step relative difference of the loss, the aux term
    and the grad norm between two runs of (loss, aux, grad norm) steps."""
    return {key: max(abs(a[i] - p[i]) / max(abs(p[i]), 1e-30)
                     for a, p in zip(kernel, plain))
            for i, key in enumerate(("loss", "moe_aux", "grad_norm"))}


def flagship_train_spread(seeds) -> None:
    """Phase 16's kernel-vs-plain comparison once per seed (weights and
    batches drawn from it): how far its reading moves with the draw; beside
    it plain against plain with K5's plain version summing K in two halves
    (gmm_plain_halves), the model's own amplification of one change of
    summation order, routed as the kernel run was."""
    reads, plain_reads = [], []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        cfg = flagship_train_config()
        model = DeepEarthModel(cfg, generator=gen, device=gen.device,
                               native_seq_lens={"vision": VISION_PATCHES,
                                                "language": 16})
        trainer = Trainer(model, cfg, FLAGSHIP_TRAIN_WEIGHTS, seed=SEED)
        start = {k: v.detach().to("cpu", copy=True)
                 for k, v in model.state_dict().items()}
        batches = [make_flagship_batch(gen, FLAGSHIP_TRAIN_BATCH,
                                       VISION_PATCHES)
                   for _ in range(TRAIN_STEPS)]
        kernel, log, _, _ = flagship_train_run(trainer, model, start,
                                               batches)
        plain, _, _, _ = flagship_train_run(trainer, model, start, batches,
                                            pinned=log, plain=True)
        halves, _, _, _ = flagship_train_run(
            trainer, model, start, batches, pinned=log, plain=True,
            plain_gmm=gmm_plain_halves)
        reads.append(train_rel(kernel, plain))
        plain_reads.append(train_rel(halves, plain))

        def per_step(a, b):
            return "; ".join(", ".join(f"{v:.3g}" for v in
                                       train_rel([x], [y]).values())
                             for x, y in zip(a, b))
        print(f"[flagship train spread] seed {seed}: per step relative "
              "difference (loss, moe_aux, grad_norm) kernel vs plain: "
              + per_step(kernel, plain) + "; plain with K summed in two "
              "halves vs plain: " + per_step(halves, plain) + f" | {card()}")
        del model, trainer, start, batches
        free_cuda()
    print("[flagship train spread] largest over the seeds, kernel vs plain: "
          + ", ".join(f"{k} {max(r[k] for r in reads):.3g}" for k in reads[0])
          + "; plain halves vs plain: " + ", ".join(
              f"{k} {max(r[k] for r in plain_reads):.3g}"
              for k in plain_reads[0])
          + f" (tol {FLAGSHIP_TRAIN_TOL}) | {card()}")


def vmem_plain_halves(q, k, v, *, scale, key_mask=None):
    """vmem_attention_plain with P.V summed over the keys in two halves,
    then added: the same function with one summation order changed
    (--mm-train-spread only)."""
    p = attention_vmem._probs(q, k, scale, key_mask).to(v.dtype).float()
    h, vf = k.shape[2] // 2, v.float()
    return (p[..., :h] @ vf[..., :h, :]
            + p[..., h:] @ vf[..., h:, :]).to(q.dtype)


def flash_plain_halves(q, k, v, *, scale, key_mask=None, causal=False):
    """flash_attention_plain's output with P.V summed over the keys in two
    halves, then added (--mm-train-spread only)."""
    s, visible = flash_attention._scores(q, k, scale, key_mask, causal)
    if visible is not None:
        s = s + torch.where(visible, 0.0, flash_attention.NEG_BIG).to(
            torch.float32)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    e = torch.exp(s - m)
    p = (e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(v.dtype).float()
    h, vf = k.shape[2] // 2, v.float()
    return (p[..., :h] @ vf[..., :h, :]
            + p[..., h:] @ vf[..., h:, :]).to(q.dtype)


# phases 12 and 13's train comparisons: (patches, batch, the attention
# site's module, its kernel's name there, the halves version, the phase's
# limits)
MM_SPREAD_SITES = ((VISION_PATCHES, MM_BATCH, attention_vmem,
                    "vmem_attention", vmem_plain_halves, TRAIN_TOL),
                   (CLIP_PATCHES, CLIP_PLAIN_BATCH, flash_attention,
                    "flash_attention", flash_plain_halves, CLIP_TRAIN_TOL))


def mm_train_spread(seeds) -> None:
    """Phases 12's and 13's kernel-vs-plain train comparisons (3 steps of
    the multimodal model at 576 patches, B=512, and at 4608, B=8) once per
    seed, the weights and batches drawn from it: how far the readings move
    with the draw; beside them plain against plain with K3's (576) or K4's
    (4608) plain version summing P.V in two halves, the model's own
    amplification of one change of summation order."""
    reads = collections.defaultdict(list)
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for patches, batch, site, name, halves, _ in MM_SPREAD_SITES:
            cfg = multimodal_config()
            model = DeepEarthModel(cfg, generator=gen, device="cuda",
                                   native_seq_lens={"vision": patches})
            trainer = Trainer(model, cfg, MM_LOSS_WEIGHTS, seed=SEED)
            start = copy.deepcopy(model.state_dict())
            batches = [make_mm_batch(gen, batch, patches)
                       for _ in range(TRAIN_STEPS)]
            runs = {}
            for label in ("kernel", "plain", "halves"):
                model.load_state_dict(start)
                st = trainer.init_state()
                swap = (mock.patch.object(site, name, halves)
                        if label == "halves" else contextlib.nullcontext())
                with (plain_versions() if label != "kernel"
                      else contextlib.nullcontext()), swap:
                    runs[label] = _run_steps(trainer, st, batches, seed=1)
                del st
            rel = {label: {key: max(abs(a[i] - b[i]) / abs(b[i]) for a, b
                                    in zip(runs[label], runs["plain"]))
                           for i, key in enumerate(("loss", "grad_norm"))}
                   for label in ("kernel", "halves")}
            reads[(patches, "kernel")].append(rel["kernel"])
            reads[(patches, "halves")].append(rel["halves"])
            print(f"[mm train spread] seed {seed}, {patches} patches, "
                  f"B={batch}: relative difference over {TRAIN_STEPS} steps "
                  f"(loss, grad_norm) kernel vs plain {rel['kernel']}; plain "
                  f"with P.V summed in two halves vs plain {rel['halves']} "
                  f"| {card()}")
            del model, trainer, start, batches
            free_cuda()
    tols = {site[0]: site[-1] for site in MM_SPREAD_SITES}
    print("[mm train spread] largest over the seeds: " + "; ".join(
        f"{patches} patches {label} vs plain " + ", ".join(
            f"{key} {max(r[key] for r in rs):.3g}" for key in rs[0])
        + f" (tol {tols[patches]})"
        for (patches, label), rs in reads.items()) + f" | {card()}")


def clip_batch_search(gen) -> None:
    """The flagship's train step at 4608 patches per observation, without
    activation checkpointing: the largest batch of CLIP_SEARCH_BATCHES that
    fits on the card, its step time, peak memory and dispatch modes."""
    cfg = flagship_train_config()
    model = DeepEarthModel(cfg, generator=gen, device=gen.device,
                           native_seq_lens={"vision": CLIP_PATCHES,
                                            "language": 16})
    trainer = Trainer(model, cfg, FLAGSHIP_TRAIN_WEIGHTS, seed=SEED)
    tried = []
    for b in CLIP_SEARCH_BATCHES:
        batch = make_flagship_batch(gen, b, CLIP_PATCHES)
        failed = False
        try:
            timing = train_timing(trainer, batch, iters=2, plain=False)
        except torch.cuda.OutOfMemoryError:
            failed = True
        model.zero_grad(set_to_none=True)
        del batch
        free_cuda()
        if failed:
            tried.append(f"B={b} out of memory")
            continue
        print(f"[clip batch search] flagship train step at {CLIP_PATCHES} "
              f"patches, no activation checkpointing: "
              + "; ".join(tried + [f"B={b} fits"])
              + f" | B={b}: step ms eager (CUDA events over 2 steps) "
              f"{turns(timing)}, {b / timing['step_ms'] * 1e3:.2f} obs/s, "
              f"peak mem {timing['peak_gib']:.2f} GiB | dispatch modes: "
              + ", ".join(f"{k} {v}" for k, v in site_modes(model).items())
              + f" | {card()}")
        return
    raise AssertionError(f"no batch fits: {tried}")


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest |x|."""
    top = x.abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def cold_ms(fn, copies: int) -> float:
    """Device time of one call of ``fn(i)``: a CUDA graph of calls cycling
    over ``copies`` copies of its weights, so that a call finds them out of
    the L2 cache, as one decode step's weights (GBs) are, and the host's
    launch cost is not in the number."""
    calls = itertools.cycle(range(copies))
    return graph_ms(lambda: fn(next(calls)), reps=max(16, copies))


def weight_copies(q: torch.Tensor) -> list:
    """q and enough copies of it to pass 100 MiB, twice the L2 cache."""
    n = max(1, -(-(100 * 2 ** 20) // q.numel()))
    return [q] + [q.clone() for _ in range(n - 1)]


def quant_case(gen, e, c, d, f, bits, x_dtype):
    """x (E, C, D) and an (E, D, F) weight quantized to ``bits`` on the
    card, columns of different magnitudes."""
    w = torch.randn((e, d, f), generator=gen, device="cuda") * torch.rand(
        (e, 1, f), generator=gen, device="cuda").add_(0.05)
    q, s = (quant.quantize_int8 if bits == 8 else quant.quantize_int4)(w)
    x = torch.randn((e, c, d), generator=gen, device="cuda").to(x_dtype)
    return x, q, s


def library_int8(x, qs, s):
    """(name, call of copy i) of torch._weight_int8pack_mm on the same E=1
    product (weights (F, D) int8 and per-row scales made once, outside the
    timing), or None where this torch has no CUDA version of it."""
    if not hasattr(torch, "_weight_int8pack_mm") or x.shape[0] != 1:
        return None
    f = s.shape[-1]
    wts = [q[0, :, :f].T.contiguous() for q in qs]
    scales = s[0, 0].to(x.dtype)
    x2 = x[0].contiguous()
    try:
        torch._weight_int8pack_mm(x2, wts[0], scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return "torch._weight_int8pack_mm", lambda i: torch._weight_int8pack_mm(
        x2, wts[i], scales)


def library_int4(x, qs, s, ref):
    """(name, call of copy i, max |library - ref|) of
    torch._weight_int4pack_mm on the same E=1 product: the weights as uint4
    (the signed nibble + 8) packed by torch._convert_weight_to_int4pack
    once, outside the timing, a zero point of 0 and the column's scale in
    every group of 128 (rounded to x's type, which the kernel does not do:
    its error is reported, not held); or None where this torch has no CUDA
    version of it or refuses the shapes."""
    if not hasattr(torch, "_weight_int4pack_mm") or x.shape[0] != 1:
        return None
    f, d = s.shape[-1], x.shape[-1]
    group, inner_k_tiles = 128, 8

    def packed(q):
        lo, hi = quant._unpack_int4(q[0, :, :f])
        u = (torch.cat([lo, hi], dim=0) + 8).T.contiguous()  # (F, D) 0..15
        return torch._convert_weight_to_int4pack(
            (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), inner_k_tiles)

    x2 = x[0].contiguous()
    scales = torch.stack([s[0, 0].expand(d // group, f),
                          torch.zeros((d // group, f), device=x.device)],
                         dim=-1).to(x.dtype).contiguous()
    try:
        wts = [packed(q) for q in qs]
        got = torch._weight_int4pack_mm(x2, wts[0], group, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return ("torch._weight_int4pack_mm",
            lambda i: torch._weight_int4pack_mm(x2, wts[i], group, scales),
            max_err(got, ref[0]))


def phase_quant(gen) -> dict:
    """K6 (int8_bmm) and K7 (int4_bmm), each by both its routes, against
    their plain versions."""
    gc.collect()
    torch.cuda.empty_cache()
    out, trees = {}, decode_trees_on_meta()
    for bits, name in ((8, "int8_bmm"), (4, "int4_bmm")):
        # the route the decode path takes (through the dispatching wrapper,
        # counted under the kernel's name) and the CUDA-core route
        routes = {"": getattr(kernels, name),
                  "_fma": getattr(kernels, name + "_fma")}
        plain = quant.int8_bmm_plain if bits == 8 else quant.int4_bmm_plain
        errs, times, route_err = {}, {}, collections.Counter()
        launches = collections.Counter()
        for case, (e, c, d, f) in QUANT_CASES.items():
            for dtype in (torch.bfloat16, torch.float32):
                x, q, s = quant_case(gen, e, c, d, f, bits, dtype)
                ref = plain(x, q, s, dtype)
                tol = (QUANT_FP32_REL * ref.abs().max().item()
                       if dtype == torch.float32 else bf16_ulp(ref))
                for suffix, kernel in routes.items():
                    kernels.reset_launch_counts()
                    got = kernel(x, q, s, dtype)
                    want = expected_launches(**{name + suffix: 1})
                    if kernels.launch_counts != want:
                        raise AssertionError(
                            f"{name}{suffix} {case}: launches "
                            f"{kernels.launch_counts} != {want}")
                    launches.update({k: v for k, v in
                                     kernels.launch_counts.items() if v})
                    if got.shape != ref.shape or got.dtype != dtype:
                        raise AssertionError(f"{name}{suffix} {case}: "
                                             f"{got.shape} {got.dtype}")
                    err = max_err(got, ref)
                    if not err <= tol:
                        raise AssertionError(
                            f"{name}{suffix} {case} {dtype}: max_abs_err "
                            f"{err} (tol {tol})")
                    errs[f"{case} {str(dtype).split('.')[-1]}{suffix}"] = err
                    route_err[suffix] = max(route_err[suffix], err)
                    if not torch.equal(kernel(x, q, s, dtype), got):
                        raise AssertionError(f"{name}{suffix} {case}: two "
                                             "runs differ")
            # times in the decode path's type, bf16, weights cold
            x, q, s = quant_case(gen, e, c, d, f, bits, torch.bfloat16)
            qs = weight_copies(q)
            t = {"library_ms": None, "library": None, "library_err": None,
                 "plain_ms": cold_ms(lambda i: plain(x, qs[i], s), len(qs))}
            for suffix, kernel in routes.items():
                t[f"{suffix[1:]}_ms" if suffix else "ms"] = cold_ms(
                    lambda i: kernel(x, qs[i], s), len(qs))
            lib = (library_int8(x, qs, s) if bits == 8 else
                   library_int4(x, qs, s, plain(x, q, s, torch.bfloat16)))
            if lib is not None:
                t["library"] = lib[0]
                t["library_ms"] = cold_ms(lib[1], len(qs))
                t["library_err"] = lib[2] if bits == 4 else None
            t.update(bound(nbytes(x, q, s) + e * c * f * 2,
                           2 * e * c * d * f, torch.bfloat16))
            times[case] = t
            del qs
        # one decode step's products at B=8, each timed cold
        step = {"ms": 0.0, "fma_ms": 0.0, "plain_ms": 0.0, "bytes": 0}
        products = decode_products(trees[bits], 8)
        if set(k[0] for k in products) != {bits} \
                or sum(products.values()) != QUANT_PER_STEP:
            raise AssertionError(f"int{bits} tree's step products: "
                                 f"{products}")
        for (_, e, c, d, f), calls in products.items():
            x, q, s = quant_case(gen, e, c, d, f, bits, torch.bfloat16)
            qs = weight_copies(q)
            for suffix, kernel in routes.items():
                key = f"{suffix[1:]}_ms" if suffix else "ms"
                step[key] += calls * cold_ms(lambda i: kernel(x, qs[i], s),
                                             len(qs))
            step["plain_ms"] += calls * cold_ms(
                lambda i: plain(x, qs[i], s), len(qs))
            step["bytes"] += calls * (nbytes(x, q, s) + e * c * f * 2)
            del qs
        step["bound_ms"] = step["bytes"] / HBM_BYTES_PER_S * 1e3
        line = times[QUANT_LINE_CASE]
        out[name] = {"max_abs_err": route_err[""], "times": times,
                     "step": step, "launches": dict(launches),
                     "fma_max_abs_err": route_err["_fma"],
                     **{k: line[k] for k in (
                         "ms", "fma_ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}}
        print(f"[17 K{6 if bits == 8 else 7} {name}] routes: tensor cores in "
              f"one cluster launch (counted {name}; the decode path's) and "
              f"CUDA cores (_fma) | launches {dict(launches)} | "
              + "max_abs_err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items())
              + f" (tol fp32 {QUANT_FP32_REL} of the largest entry, bf16 one"
              " ulp of it) | two runs of each route bitwise equal | ms, bf16 "
              "x, weights out of L2 (CUDA-graph replays): " + ", ".join(
                  f"{k} kernel {t['ms']:.4f} fma route {t['fma_ms']:.4f}"
                  f" plain {t['plain_ms']:.4f} bound {t['bound_ms']:.4f} "
                  f"({t['bound_by']}) library {fmt(t['library_ms'])}"
                  + (f" (max_abs_err vs plain {t['library_err']:.3g})"
                     if t["library_err"] is not None else "")
                  for k, t in times.items())
              + f" | library: {line['library'] or 'none'} | one decode "
              f"step's {QUANT_PER_STEP} products at B=8: kernel "
              f"{step['ms']:.3f} ms, fma route {step['fma_ms']:.3f}"
              f", plain {step['plain_ms']:.3f}, bound "
              f"{step['bound_ms']:.3f} ({step['bytes'] / 1e9:.3f} GB) | "
              f"{card()}")
    return out


def decode_config() -> DeepSeekBlockConfig:
    """tools/bench_decode.py:67-86: 2.424B parameters, 20 layers of hidden
    2048, MLA 16 heads (kv_lora 512, rope 64, nope 128, v 128), 16 experts
    of 1024 with top-4 and a shared expert past layer 0."""
    return DeepSeekBlockConfig(
        hidden_dim=2048, n_layers=20, intermediate_size=8192,
        mla=MLAConfig(hidden_dim=2048, n_heads=16, kv_lora_rank=512,
                      qk_rope_head_dim=64, qk_nope_head_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(n_routed_experts=16, num_experts_per_tok=4,
                      moe_intermediate_size=1024, hidden_dim=2048,
                      n_shared_experts=1),
        first_k_dense_replace=1)


def decode_trees_on_meta() -> dict:
    """The int8 and int4 trees of decode_config()'s model on the meta
    device: their shapes, and no memory."""
    model = DeepSeekForCausalLM(decode_config(), DECODE_VOCAB,
                                generator=torch.Generator(), device="meta",
                                compute_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    return {bits: quant.quantize_decoder_params(model, bits=bits)
            for bits in (8, 4)}


def decode_products(tree, batch: int) -> collections.Counter:
    """(bits, E, C, D, F) -> calls of every K6 / K7 product of one decode
    step of a quantized tree at ``batch`` tokens: each QuantDense once at
    E=1, C=batch; each quantized MoE layer's w_gate, w_up and w_down at
    E experts of capacity(batch) slots."""
    out = collections.Counter()

    def add(w4, w8, scale, e, c):
        bits, w = (4, w4) if w4 is not None else (8, w8)
        out[(bits, e, c, w.shape[-2] * (8 // bits), scale.shape[-1])] += 1

    for m in tree.modules():
        if isinstance(m, quant.QuantDense):
            add(getattr(m, "kernel_q4", None), getattr(m, "kernel_q", None),
                m.scale, 1, batch)
        elif quant.is_quantized_moe(m):
            c = capacity(m.cfg, batch)
            for key in ("w_gate", "w_up", "w_down"):
                add(getattr(m, key + "_q4", None),
                    getattr(m, key + "_q", None),
                    getattr(m, key + "_scale"), m.cfg.n_routed_experts, c)
    return out


def teacher_forced(model, ids, pinned=None, plain=False):
    """Logits (B, S, vocab) of every prompt position through the decode
    step, and the log of the MoE gates' choices (pinned to an earlier run's
    with ``pinned``)."""
    b, n = ids.shape
    caches = [init_cache(model.cfg.mla, b, n, torch.bfloat16, ids.device)
              for _ in range(model.cfg.n_layers)]
    logits = []
    with gate_log(pinned) as log, \
            (plain_versions() if plain else contextlib.nullcontext()):
        for t in range(n):
            step, caches = causal_lm_decode_step(model, caches, ids[:, t], n)
            logits.append(step)
    return torch.stack(logits, dim=1), log


def phase_decode(gen) -> dict:
    """Greedy decode at tools/bench_decode.py's config over bf16, int8 and
    int4 trees: the decode path's main run for K6 and K7."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg, dev = decode_config(), gen.device
    t0 = time.perf_counter()
    model = DeepSeekForCausalLM(cfg, DECODE_VOCAB, generator=gen,
                                device=dev, compute_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16).eval()
    trees = {"bf16": model,
             "int8": quant.quantize_decoder_params(model, bits=8),
             "int4": quant.quantize_decoder_params(model, bits=4)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tree_bytes = {k: quant.quantized_bytes(t) for k, t in trees.items()}
    for tag, want in BENCH_DECODE_BYTES.items():
        if tree_bytes[tag]["total_bytes"] != want:
            raise AssertionError(f"{tag} tree: {tree_bytes[tag]} bytes, "
                                 f"BENCH_DECODE.json counts {want}")
    for tag, bits in (("int8", 8), ("int4", 4)):
        products = decode_products(trees[tag], 1)
        if set(k[0] for k in products) != {bits} \
                or sum(products.values()) != QUANT_PER_STEP:
            raise AssertionError(f"{tag} tree's step products: {products}")
    prompts = {b: torch.randint(0, DECODE_VOCAB, (b, DECODE_PROMPT),
                                generator=gen, device=dev)
               for b in DECODE_BATCHES}

    # the main path: generate through each tree, counted, no plain version
    runs, tokens, launches = {}, {}, {}
    for tag, tree in trees.items():
        kernel = {"int8": "int8_bmm", "int4": "int4_bmm"}.get(tag)
        want = expected_launches(**({kernel: DECODE_STEPS * QUANT_PER_STEP}
                                    if kernel else {}))
        for b, ids in prompts.items():
            with torch.inference_mode(), plain_versions_refused():
                generate(tree, ids[:, :2], 1,  # warm-up at this batch
                         cache_dtype=torch.bfloat16)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = generate(tree, ids, DECODE_NEW,
                                cache_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = dict(kernels.launch_counts)
            if got != want:
                raise AssertionError(f"{tag} B={b}: launches {got} != {want}")
            if toks.shape != (b, DECODE_NEW) or toks.dtype != torch.int32 \
                    or not bool(((toks >= 0) & (toks < DECODE_VOCAB)).all()):
                raise AssertionError(f"{tag} B={b}: tokens {toks.shape} "
                                     f"{toks.dtype} out of range")
            runs[(tag, b)] = {
                "wall_s": wall, "tokens_per_s": b * DECODE_NEW / wall,
                "ms_per_step": wall / DECODE_STEPS * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            tokens[(tag, b)] = toks
            launches[(tag, b)] = got

    # where one step's time goes: int8 at B=8, a step past the prompt
    b8 = prompts[8]
    with torch.inference_mode():
        caches = [init_cache(cfg.mla, 8, DECODE_PROMPT + 8, torch.bfloat16,
                             dev) for _ in range(cfg.n_layers)]
        for t in range(DECODE_PROMPT):
            _, caches = causal_lm_decode_step(trees["int8"], caches,
                                              b8[:, t], DECODE_PROMPT + 8)
        tok = b8[:, -1]
        step_ms = host_ms(lambda: causal_lm_decode_step(
            trees["int8"], caches, tok, DECODE_PROMPT + 8), iters=5)
        breakdown, by_op = kernel_breakdown(lambda: causal_lm_decode_step(
            trees["int8"], caches, tok, DECODE_PROMPT + 8), n_calls=3)
    busy = sum(r[1] for r in breakdown)
    # K6's share of the step: its tensor-core kernel's rows (the profiler
    # may drop an event now and then; the launch counters above hold the
    # count)
    k6_rows = [r for r in breakdown if "int8_bmm_tc_kernel" in r[0]]
    k6_ms, k6_calls = (sum(r[1] for r in k6_rows),
                       sum(r[2] for r in k6_rows))

    # kernel vs plain at B=8: the prompt teacher-forced, the plain run
    # routed as the kernel run was; then greedy tokens without pinning
    compare = {}
    with torch.inference_mode():
        for tag in ("int8", "int4"):
            lk, log_k = teacher_forced(trees[tag], b8)
            lp, log_p = teacher_forced(trees[tag], b8, pinned=log_k,
                                       plain=True)
            flips = torch.stack([(x.sort(dim=-1).values
                                  != y.sort(dim=-1).values).any(dim=-1)
                                 for x, y in zip(log_k, log_p)]).float()
            diff = (lk - lp).abs()
            with plain_versions():
                toks_p = generate(trees[tag], b8, DECODE_NEW,
                                  cache_dtype=torch.bfloat16)
            same = tokens[(tag, 8)] == toks_p
            parted = (~same).int().argmax(dim=1)
            compare[tag] = {
                "max_abs": diff.max().item(),
                "max_over_ulp": diff.max().item() / bf16_ulp(lp),
                "mean_rel": diff.mean().item() / lp.abs().mean().item(),
                "flipped": flips.mean().item(),
                "flipped_max": flips.mean(dim=1).max().item(),
                "greedy_agree": same.float().mean().item(),
                "first_parted": [int(p) if not bool(s.all()) else None
                                 for p, s in zip(parted, same)]}
            del lk, lp

    print(f"[18 decode] tools/bench_decode.py's config: {n_params / 1e9:.4f}B"
          f" params (bf16, tied embeddings), 3 trees built in {build_s:.1f} s;"
          " tree bytes " + ", ".join(
              f"{k} {v['total_bytes']:,} ({v['int8_bytes'] / v['total_bytes']:.3f}"
              f" quantized; floor {v['total_bytes'] / HBM_BYTES_PER_S * 1e3:.3f}"
              " ms)" for k, v in tree_bytes.items())
          + " = BENCH_DECODE.json's | cache bytes per token per layer "
          f"{cache_bytes_per_token(cfg.mla, 2)} (bf16) vs full K/V "
          f"{full_cache_bytes_per_token(cfg.mla, 2)} | prefill "
          f"{DECODE_PROMPT} + {DECODE_NEW} new tokens, greedy, bf16 cache; "
          "per generate call wall s, decode tokens/s, ms per step "
          f"({DECODE_STEPS} steps), peak GiB: " + ", ".join(
              f"{tag} B={b} {r['wall_s']:.3f}, {r['tokens_per_s']:.1f}, "
              f"{r['ms_per_step']:.3f}, {r['peak_gib']:.2f}"
              for (tag, b), r in runs.items())
          + f" | launches per call: K6 {launches[('int8', 8)]['int8_bmm']} "
          "on its tensor-core route and "
          f"{launches[('int8', 8)]['int8_bmm_fma']} on its CUDA-core one "
          f"(int8), K7 {launches[('int4', 8)]['int4_bmm']} and "
          f"{launches[('int4', 8)]['int4_bmm_fma']} (int4), none at "
          f"bf16 = {DECODE_STEPS} x {QUANT_PER_STEP}; no plain version "
          f"reached | one int8 step at B=8: host {min(step_ms):.2f}-"
          f"{max(step_ms):.2f} ms, kernels busy {busy:.3f} ms in "
          f"{sum(r[2] for r in breakdown):.0f} launches, K6 {k6_ms:.3f} ms "
          f"of it in {k6_calls:.0f} | kernel vs "
          "plain at B=8, the prompt teacher-forced with routing pinned: "
          + ", ".join(
              f"{k} logits max {v['max_abs']:.4g} ({v['max_over_ulp']:.2f} "
              f"bf16 ulps of the largest) mean/mean|plain| "
              f"{v['mean_rel']:.3g}, routing flipped {v['flipped']:.4f} "
              f"(worst step {v['flipped_max']:.4f}), greedy tokens agreeing "
              f"{v['greedy_agree']:.4f} (rows part at {v['first_parted']})"
              for k, v in compare.items())
          + f" | {card()}")
    print_breakdown(18, "one int8 decode step at B=8", "step", breakdown,
                    by_op)
    for tag, v in compare.items():
        if any(v[k] > DECODE_TOL[k] for k in DECODE_TOL):
            raise AssertionError(f"decode kernel vs plain, {tag}: {v} (tol "
                                 f"{DECODE_TOL})")
    return {"launches": {"int8_bmm": launches[("int8", 8)]["int8_bmm"],
                         "int4_bmm": launches[("int4", 8)]["int4_bmm"]},
            "runs": runs, "compare": compare}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--clip-batch-search", action="store_true",
                        help="only the flagship's train step at 4608 patches"
                             ": the largest batch that fits")
    parser.add_argument("--flagship-train-spread", type=int, nargs="+",
                        metavar="SEED",
                        help="only phase 16's kernel-vs-plain train "
                             "comparison, once per seed")
    parser.add_argument("--mm-train-spread", type=int, nargs="+",
                        metavar="SEED",
                        help="only phases 12's and 13's kernel-vs-plain "
                             "train comparisons, once per seed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_build()
    if args.clip_batch_search:
        clip_batch_search(gen)
        return
    if args.flagship_train_spread:
        flagship_train_spread(args.flagship_train_spread)
        return
    if args.mm_train_spread:
        mm_train_spread(args.mm_train_spread)
        return
    k2 = phase_hash(gen)
    k1 = phase_attention(gen)
    sl = phase_slice(gen)
    k1b = phase_attention_bwd(gen)
    k2b = phase_hash_bwd(gen)
    tr = phase_train(gen)
    k3 = phase_vmem(gen)
    mm = phase_multimodal(gen)
    k3b = phase_vmem_bwd(gen)
    k4, k4b = phase_flash(gen)
    mmt = phase_mm_train(gen)
    clip = phase_clip(gen)
    k5 = phase_gmm(gen)
    # K5-bwd's cases draw from a generator of their own, seeded from SEED, as
    # phases 15 and 16 do: the cases phase 14's K5-fwd part adds no longer
    # move their draw (one of the 64 dlhs entries of its M=1 case sat on a
    # rounding boundary in the draw they moved it to; PERF.md)
    k5b = phase_gmm_bwd(torch.Generator(device="cuda").manual_seed(SEED))
    flag = phase_flagship(flagship_generator())
    flag_train = phase_flagship_train(flagship_generator())
    k67 = phase_quant(gen)
    dec = phase_decode(gen)
    report = {"kernels": [
        {"name": "hash_encode_fwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/hash_encode.cu",
         "replaces": "deepearth_tpu/ops/hash_encoding.py:113",
         "launches": sl["launches"]["hash_encode_fwd"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
        {"name": "pairwise_attention_fwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/pairwise_attention_fwd_tma.cu",
         "replaces": "deepearth_tpu/ops/attention_smallseq.py:156",
         "launches": sl["launches"]["pairwise_attention_fwd"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "pairwise_attention_bwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/pairwise_attention_bwd_tma.cu",
         "replaces": "deepearth_tpu/ops/attention_smallseq.py:172",
         "launches": tr["launches"]["pairwise_attention_bwd"],
         "max_abs_err": k1b["max_abs_err"], "ms": k1b["ms"],
         "plain_ms": k1b["plain_ms"]},
        {"name": "hash_encode_bwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/hash_encode.cu",
         "replaces": "deepearth_tpu/ops/hash_encoding.py:101",
         "launches": tr["launches"]["hash_encode_bwd"],
         "max_abs_err": k2b["max_abs_err"], "ms": k2b["ms"],
         "plain_ms": k2b["plain_ms"]},
        {"name": "vmem_attention_fwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/attention_vmem_fwd_tma.cu",
         "replaces": "deepearth_tpu/ops/attention_vmem.py:64",
         "launches": mm["launches"]["vmem_attention_fwd"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"]},
        {"name": "vmem_attention_bwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/flash_attention_bwd_tma.cu",
         "replaces": "deepearth_tpu/ops/attention_vmem.py:72",
         "launches": mmt["launches"]["vmem_attention_bwd"],
         "max_abs_err": k3b["max_abs_err"], "ms": k3b["ms"],
         "plain_ms": k3b["plain_ms"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/flash_attention_fwd_tma.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:331"
                     " (called at deepearth_tpu/models/deepseek.py:267)",
         "launches": clip["launches"]["flash_attention_fwd"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source":
             "deepearth_tpu_torch/kernels/csrc/flash_attention_bwd_tma.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"
                     " and :1456 (dkv and dq)",
         "launches": clip["launches"]["flash_attention_bwd"],
         "max_abs_err": k4b["max_abs_err"], "ms": k4b["ms"],
         "plain_ms": k4b["plain_ms"]},
        {"name": "grouped_matmul_fwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/grouped_matmul_tma.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314 "
                     "(called at deepearth_tpu/ops/moe.py:359, :362, :366)",
         "launches": flag["launches"]["grouped_matmul_fwd"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"]},
        {"name": "grouped_matmul_split_dout", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/grouped_matmul_bwd.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/megablox/ops.py:63 "
                     "(_gmm_bwd's fp32 grad, read by :80 and :90)",
         "launches": flag_train["launches"]["grouped_matmul_split_dout"],
         "max_abs_err": k5b["split"]["max_abs_err"],
         "ms": k5b["split"]["ms"], "plain_ms": k5b["split"]["plain_ms"]},
        {"name": "grouped_matmul_bwd_dlhs", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/grouped_matmul_bwd_tma.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/megablox/ops.py:63 "
                     "(_gmm_bwd: gmm with transpose_rhs at :80)",
         "launches": flag_train["launches"]["grouped_matmul_bwd_dlhs"],
         "max_abs_err": k5b["dlhs"]["max_abs_err"], "ms": k5b["dlhs"]["ms"],
         "plain_ms": k5b["dlhs"]["plain_ms"]},
        {"name": "grouped_matmul_bwd_drhs", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/grouped_matmul_bwd_tma.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/megablox/ops.py:63 "
                     "(_gmm_bwd: tgmm at :90, megablox/gmm.py:573)",
         "launches": flag_train["launches"]["grouped_matmul_bwd_drhs"],
         "max_abs_err": k5b["drhs"]["max_abs_err"], "ms": k5b["drhs"]["ms"],
         "plain_ms": k5b["drhs"]["plain_ms"]},
        {"name": "int8_bmm", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/quant_matmul_tc.cu",
         "replaces": "deepearth_tpu/ops/quant.py:159",
         "launches": dec["launches"]["int8_bmm"],
         "max_abs_err": k67["int8_bmm"]["max_abs_err"],
         "ms": k67["int8_bmm"]["ms"], "plain_ms": k67["int8_bmm"]["plain_ms"]},
        {"name": "int4_bmm", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/quant_matmul_tc.cu",
         "replaces": "deepearth_tpu/ops/quant.py:240",
         "launches": dec["launches"]["int4_bmm"],
         "max_abs_err": k67["int4_bmm"]["max_abs_err"],
         "ms": k67["int4_bmm"]["ms"], "plain_ms": k67["int4_bmm"]["plain_ms"]},
    ]}
    # each kernel's bound and library call; K3's numbers add its MLA and
    # cross sites at B=512 (per forward, per step); K4's are at
    # CLIP_PLAIN_BATCH, where the plain version fits; K5's at the flagship
    # simulator's B=64 shape; K6's and K7's at QUANT_LINE_CASE
    for entry, phase in zip(report["kernels"],
                            (k2, k1, k1b, k2b, k3, k3b, k4, k4b, k5,
                             k5b["split"], k5b["dlhs"], k5b["drhs"],
                             k67["int8_bmm"],
                             k67["int4_bmm"])):
        entry.update({key: phase[key] for key in
                      ("bound_ms", "bound_by", "library_ms")})
    for k in report["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    # the mma.sync routes of K3, K4, K5-fwd and K5-bwd take the bf16 shapes
    # TMA cannot (head dims, strides, K or N off the 8-element grid), K6's
    # and K7's CUDA-core routes the shapes off their tensor-core grid,
    # K1's warp routes fp32 and the shapes off its streaming grid, K2-bwd's
    # scalar route F != 2: no main path reaches them, so their launches are
    # phases 3's, 5's, 6's, 8's, 10's, 11's, 14's and 17's, their times the
    # timed shapes' through their wrappers
    mma_of = {"pairwise_attention_fwd": (
                  "deepearth_tpu_torch/kernels/csrc/pairwise_attention.cu",
                  "launches_in_phase_3", k1),
              "hash_encode_bwd": (
                  "deepearth_tpu_torch/kernels/csrc/hash_encode.cu",
                  "launches_in_phase_6", k2b),
              "pairwise_attention_bwd": (
                  "deepearth_tpu_torch/kernels/csrc/pairwise_attention_bwd.cu",
                  "launches_in_phase_5", k1b),
              "vmem_attention_fwd": (
                  "deepearth_tpu_torch/kernels/csrc/attention_vmem.cu",
                  "launches_in_phase_8", k3),
              "vmem_attention_bwd": (
                  "deepearth_tpu_torch/kernels/csrc/attention_vmem_bwd.cu",
                  "launches_in_phase_10", k3b),
              "flash_attention_fwd": (
                  "deepearth_tpu_torch/kernels/csrc/flash_attention.cu",
                  "launches_in_phase_11", k4),
              "flash_attention_bwd": (
                  "deepearth_tpu_torch/kernels/csrc/flash_attention.cu",
                  "launches_in_phase_11", k4b),
              "grouped_matmul_fwd": (
                  "deepearth_tpu_torch/kernels/csrc/grouped_matmul.cu",
                  "launches_in_phase_14", k5),
              "grouped_matmul_bwd_dlhs": (
                  "deepearth_tpu_torch/kernels/csrc/grouped_matmul_bwd.cu",
                  "launches_in_phase_14", k5b["dlhs"]),
              "grouped_matmul_bwd_drhs": (
                  "deepearth_tpu_torch/kernels/csrc/grouped_matmul_bwd.cu",
                  "launches_in_phase_14", k5b["drhs"]),
              "int8_bmm": (
                  "deepearth_tpu_torch/kernels/csrc/quant_matmul.cu",
                  "launches_in_phase_17", k67["int8_bmm"]),
              "int4_bmm": (
                  "deepearth_tpu_torch/kernels/csrc/quant_matmul.cu",
                  "launches_in_phase_17", k67["int4_bmm"])}
    # the others' old routes: _mma
    suffix_of = {"pairwise_attention_fwd": "_warp",
                 "pairwise_attention_bwd": "_warp",
                 "hash_encode_bwd": "_scalar", "int8_bmm": "_fma",
                 "int4_bmm": "_fma"}
    phase_launches = {"pairwise_attention_fwd": k1["launches"],
                      "hash_encode_bwd": k2b["launches"],
                      "pairwise_attention_bwd": k1b["launches"],
                      "vmem_attention_fwd": k3["launches"],
                      "vmem_attention_bwd": k3b["launches"],
                      "flash_attention_fwd": k4["launches"],
                      "flash_attention_bwd": k4b["launches"],
                      "grouped_matmul_fwd": k5["launches"],
                      "grouped_matmul_bwd_dlhs": k5b["launches"],
                      "grouped_matmul_bwd_drhs": k5b["launches"],
                      "int8_bmm": k67["int8_bmm"]["launches"],
                      "int4_bmm": k67["int4_bmm"]["launches"]}

    def off_main(entry):
        name = entry["name"]
        suffix = suffix_of.get(name, "_mma")
        source, count, numbers = mma_of[name]
        return {"name": name + suffix, "route": "cuda", "source": source,
                "replaces": entry["replaces"],
                count: phase_launches[name].get(name + suffix, 0),
                "max_abs_err": numbers[f"{suffix[1:]}_max_abs_err"],
                "ms": numbers[f"{suffix[1:]}_ms"],
                **{key: entry[key] for key in ("plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}}
    report["off_main_path"] = [off_main(entry) for entry in report["kernels"]
                               if entry["name"] in mma_of]
    print(json.dumps(report))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
