#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepearth_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device and build: requires CUDA, prints the card, builds the kernels;
  2. K2-fwd: the Grid4D encode (grid4d_encode_fwd: every table, masks,
     concatenation and cast in one launch) bit for bit against the plain
     composition at the A-stack's, the decompositions' and odd configs,
     fp32 and bf16, masks absent, partial and all False, xyzt strided, two
     runs alike; F = 3 on the per-table kernel (hash_encode_fwd), which
     is also held against its plain version; times of the whole encode (one
     launch, the per-table composition, plain) at B=4096 with and without
     masks, B=512 and B=1, beside its bound and its design's floor, and of
     the spatial and temporal tables alone on the per-table kernel;
  3. K1-fwd (pairwise_attention_fwd) against its plain PyTorch version, by
     both its routes (as K1-bwd's in phase 5: 8 lanes a (row, head) on
     16-byte register loads, or a warp a (row, head)), at phase 5's cases;
     the route and launches per case, all-masked rows exactly 0, two runs
     bitwise equal; times of both routes, the plain version, the library
     and the bound at the A-stack shape;
  4. the serving slice: DeepEarthModel at the A-stack configuration (hidden
     768, 12 heads, 12 fusion layers, Grid4D 16 levels on 2^19 tables + 8 on
     2^17, species vocab 232, bf16 compute) answers requests of 1, 37 and
     4096 observations; every forward must launch K2-fwd once and K1-fwd 16
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
     K2-fwd 1, K2-bwd 2 (dense), K1-fwd 16 and K1-bwd 16 times (both on
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
     launch K3-fwd 2 (on its TMA route), K2-fwd 1 and K1-fwd 0 times and
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
     launch K3-fwd 2, K3-bwd 2 (both on their TMA routes), K2-fwd 1, K2-bwd
     2 and nothing else, and reach no plain version; 3 steps against the plain
     path, the loss must
     fall on one repeated batch; step time, peak memory, per-op profile;
 13. the multimodal model at 4608 patches per observation: requests of 1
     and 16 (K4-fwd 1 on its TMA route, K2-fwd 1 per forward) and
     Trainer.fit at B=64 (K4-fwd 1 and K4-bwd 1 on their TMA routes, K2-fwd
     1, K2-bwd 2 per step), no plain version reached;
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
     (on its TMA route), K2-fwd 1 and, at B=64 where the simulator takes
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
     routes), K2-fwd 1, K2-bwd 2 and nothing else, and reach no plain
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
 19. the embedding service through the user's entry points: the README's
     quick start (DeepEarth() on the card, a temperature and a species
     source, predict), then DeepEarth(hidden_dim=768, n_layers=12) with
     the same sources: predict_batch of 4096 observations (with
     reconstructions) and 8 single predicts, each request launching K2-fwd
     1 and K1-fwd 16 times (the quick start's 4 layers: 6), no plain
     version reached, the outputs against the same calls through the
     plain versions (phase 4's SLICE_TOL); the REST path
     (DashboardServer(DataService(predictor=earth)) on 127.0.0.1, port 0,
     DashboardClient.predict) for 8 requests, each answer bit for bit
     predict's; save -> a fresh DeepEarth(...).load on the card predicts
     the same bits; obs/s at B=4096, the median ms of a predict and of a
     REST request (host wall, synchronised), beside the plain versions';
 20. the training entry point and its siblings, as a user runs them: (a)
     cli.train.main at the A-stack's width (768, 12 layers) on synthetic
     data at B=4096 for 8 steps, with a checkpoint directory and a metrics
     file; every step must launch K1-fwd 16, K1-bwd 16 (streaming routes),
     K2-fwd 1 and K2-bwd 2 and nothing else, reach no plain version, and
     get every batch leaf on the card; from that run's steps 3-8 under a
     device-only profiler: ms a step by CUDA events, obs/s, the
     host-to-device copies a step and whether they are pinned, kernel time
     and the device's idle share; (b) the same command through the plain
     versions, loss and grad norm of each step within TRAIN_TOL; (c)
     Trainer.fit with echo_factor=2 over
     device_prefetch: half the batches pulled and half the copies a step;
     --resume with no step loads the saved state bit for bit; (d)
     cli.prepare_data writes vision (576 x 1408, fp16) and language (7168)
     stores over 512 observations, then --data-dir's body
     (train_on_dataset) trains 10 steps at B=64 from an ObservationDataset,
     one profiled run with device_prefetch and one with
     device_prefetch_compressed: launches a step (which attention kernels
     run), ms a step, the copies' share of a step, the idle share; the
     same steps through the plain versions within TRAIN_TOL; K3-fwd and
     K3-bwd at every site shape the run gave them against their plain
     versions; the native gather bit for bit the store's read; (e)
     cli.serve with a predictor on port 0 answers one REST predict bit for
     bit DeepEarth.predict's;
 21. the token-sequence paths: (a) K4-fwd and K4-bwd at heads above 128
     on each route (TMA, mma.sync, CUDA cores) against their plain
     versions: DeepSeek-V3's MLA (1 x 128 heads x 4096, Dqk 192, Dv 128)
     and 256 / 256 over a V-JEPA2 clip (8 x 8 x 4608), timed beside the
     bound and scaled_dot_product_attention, plus masked, causal, partial-
     panel and off-grid cases; (b) DeepSeekForSequenceClassification at
     DeepSeek-V3's published widths (hidden 7168, 128 heads, q-LoRA 1536,
     kv-LoRA 512, yarn x40, vocab 129280), cut to its 3 dense layers, bf16,
     flash on: forwards at B=1 N=4096 and B=2 N=2048 (a key mask), K4-fwd 3
     a forward on its TMA route, the stack's output against the plain path
     (SLICE_TOL); a cross-entropy backward at B=1 N=2048, K4-bwd 3, loss
     and grad norm against the plain path (TRAIN_TOL); (c) the multimodal
     train step of phase 12's model with vision decode_sequence and a text
     token_sequence modality (512 ids, vocab 32000) at B=64 with the
     config's MLM and MAE masks: K3-fwd 4, K3-bwd 4, K2 1/2 a step, 3 steps
     against the plain path (TRAIN_TOL); (d) cli.convert_checkpoint
     --verify on a DeepSeek-V3-shaped .safetensors checkpoint written here,
     then cli.generate, 32 greedy tokens on the card, equal to an
     in-process generate on the same parameters; the phase's wall time;
 22. activation checkpointing and the rest of models/: (a) phase 16's
     flagship train step (576 patches, B=64) for 3 steps with remat off,
     then with every modality's encoder_remat and fusion.remat at 'full'
     and at 'dots', each run's model built from one seed: loss, aux term
     and grad norm against remat off (FLAGSHIP_TRAIN_TOL), dispatch modes
     and routed-token counts equal at every site and step, every kernel's
     launches a step as without remat except the forward kernels inside the
     checkpointed blocks (K5-fwd, K3-fwd), which must rise; step ms by CUDA
     events and peak memory per run; (b) the C-stack at its published
     widths: BidirectionalReconstructor(full_vision_output=True) trained 3
     make_bidirectional_steps on clips of 8 x 24 x 24 x 1408 at B=256,
     MultimodalAutoencoder (232 species) 3 make_autoencoder_steps at B=512,
     MultimodalSharedSpace over (B, 576, 1408) and (B, 7168) at B=64 (K3-fwd
     and K3-bwd at 577 keys, against the plain path: SLICE_TOL, TRAIN_TOL),
     MultimodalUNet and BimodalMLPUNet train steps and species_topk; (c)
     ModalityEncoder at 768 / 12 on B=4096, a 4-layer Transformer at 768 /
     12 over 576 tokens with interleaved RoPE (K3 4/4 a step) and a 3-level
     HierarchicalFusion over the multimodal fusion at B=512 (K1 on its last,
     8-token level), each against the plain path; (d)
     create_inductive_simulator('standard') with its flash gate on, B=8 x
     1024 tokens with a token_mask: a forward (K4-fwd 24, K5-fwd 69)
     against the plain path with routing pinned, a backward with remat
     against one without (TRAIN_TOL); each part from a generator of its own
     seeded from SEED; the phase's wall time;
 23. Gaussian splatting, the viewer and export, at tools/bench_splat.py's
     width (256 x 256, fx = fy = 220, camera at z = 2.5, tiles of 16, K =
     512, 3.5 sigma; scenes from init_scene): (a) render_tiled at G =
     2,000, 16,000, 65,536 and 262,144 and the dense render at 2,000 and
     16,000, each launching K8 (splat_bin, tiled) and K9-fwd
     (splat_composite_fwd) once and held against the plain path; K8 bit
     for bit against bin_tiles_plain and bin_tiles_chunked_plain (and at
     splat_bin_edges' cases and splat_bin_grids' grids, two launches
     bitwise equal), K9-fwd and K9-bwd (splat_composite_bwd) against their
     plain versions at each scene's lists (SPLAT_IMAGE_TOL, SPLAT_GRAD_TOL;
     K9-bwd at the tiled sizes and the dense 2,000), each timed by
     CUDA-graph replays (events beside) next to its plain version, its
     bound and its exp floor; (b) 3
     make_train_step steps (Adam) tiled at 65,536 and dense at 2,000, K8
     1, K9-fwd 1, K9-bwd 1 a step, against the plain path from one state
     (SPLAT_TRAIN_TOL), and fit_scene_adaptive on the tiled renderer with
     at least one densify that resizes the scene, whose loss must fall by
     half; (c) DataService(viewer_views=...) answering GET /visualizer on
     127.0.0.1 with the viewer's HTML, and export_model_forward of the
     A-stack api.DeepEarth serves (768 / 12, the quick start's sources, B =
     64) reloaded with load_exported: its launches K2-fwd 1 and K1-fwd 16
     through the registered operators, its outputs the eager forward's bit
     for bit; the phase's wall time;
then a JSON line of the kernels, the card's name and power limit, and
{"ok": true, ...} as the last line. Any failure raises and exits non-zero.
Weights are random, drawn from a seeded generator on the card.

    python3 chip_smoke.py --clip-batch-search

runs only the flagship's train step at 4608 patches per observation and
prints the largest batch that fits without activation checkpointing, then
the largest with every modality's encoder_remat and fusion.remat at
'full', with each one's step ms and peak memory, without the last two
lines.

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

    python3 chip_smoke.py --splat-plans

runs only K9-fwd and K9-bwd at phase 23's tiled (G = 65,536) and dense
(G = 2,000) scenes under kernels.splat_plan's split of the lists and the
others of SPLAT_PLAN_SWEEP, timed by CUDA-graph replays, without the last
two lines.

    python3 chip_smoke.py --splat-bin

runs only K8 at phase 23's tiled scenes (G = 2,000 to 262,144), timed by
CUDA-graph replays and by events, bit for bit against bin_tiles_plain,
without the last two lines. Copied into another tree's root and run there
(the parent commit unpacked with git archive), it times that tree's K8:
parent, this tree, this tree, parent in one machine compares the two.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import time
import urllib.request
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.api import DeepEarth
from deepearth_tpu_torch.cli import convert_checkpoint as cli_convert
from deepearth_tpu_torch.cli import generate as cli_generate
from deepearth_tpu_torch.cli import prepare_data as cli_prepare
from deepearth_tpu_torch.cli import serve as cli_serve
from deepearth_tpu_torch.cli import train as cli_train
from deepearth_tpu_torch.data import (
    ObservationDataset,
    SyntheticConfig,
    SyntheticEarthDataGenerator,
    device_prefetch_compressed,
    native,
)
from deepearth_tpu_torch.data import device_prefetch as data_device_prefetch
from deepearth_tpu_torch.data.batches import leaves as batch_leaves
from deepearth_tpu_torch.configs import (
    DeepEarthConfig,
    DeepSeekBlockConfig,
    Grid4DConfig,
    HashEncodingConfig,
    MLAConfig,
    ModalityConfig,
    MoEConfig,
    OptimizerConfig,
    TransformerConfig,
    integrated_config,
    simulator_config,
)
from deepearth_tpu_torch.models import (
    BidirectionalReconstructor,
    BimodalMLPUNet,
    DeepEarthModel,
    DeepSeekForCausalLM,
    DeepSeekForSequenceClassification,
    DeepSeekTransformer,
    HierarchicalFusion,
    MaskingStrategy,
    ModalityEncoder,
    MultimodalAutoencoder,
    MultimodalSharedSpace,
    MultimodalUNet,
    Transformer,
    config_from_hf,
    MoELayer,
    cache_bytes_per_token,
    causal_lm_decode_step,
    create_inductive_simulator,
    full_cache_bytes_per_token,
    fusion,
    generate,
    init_cache,
    species_topk,
)
from deepearth_tpu_torch.models import grid4d as grid4d_model
from deepearth_tpu_torch.models.deepseek import capacity
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import (
    attention_smallseq,
    attention_vmem,
    flash_attention,
    grid4d_encode,
    grouped_matmul,
    hash_encoding,
    moe,
    quant,
    splat,
)
from deepearth_tpu_torch.serving import (
    DashboardClient,
    DashboardServer,
    DataService,
)
from deepearth_tpu_torch.training import (
    LossWeights,
    Trainer,
    TrainState,
    create_optimizer,
    make_autoencoder_step,
    make_bidirectional_step,
)
from deepearth_tpu_torch.training import trainer as trainer_module
from deepearth_tpu_torch.convert import load_flax_params
from deepearth_tpu_torch.export import export_model_forward, load_exported
from deepearth_tpu_torch.reconstruction import (
    Camera,
    CameraIntrinsics,
    ViewCloud,
    euler_adjust_matrix,
    render_viewer_html,
    unproject_depth,
)
from deepearth_tpu_torch.reconstruction import gaussian_splat
from deepearth_tpu_torch.serving.language_server import HashEmbedder
from deepearth_tpu_torch.utils.checkpoint_files import read_msgpack_tree

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
# K2-fwd: one launch a Grid4D forward (grid4d_encode_fwd); K2-bwd: one call
# a table in a train step (hash_encode_bwd, spatial and temporal)
K2_PER_FORWARD, K2_BWD_PER_STEP, K1_PER_FORWARD = 1, 2, 16
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
               "grid4d_encode_fwd": K2_PER_FORWARD,
               "hash_encode_bwd": K2_BWD_PER_STEP}
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
CLIP_PER_FORWARD = {"flash_attention_fwd": 1,
                    "grid4d_encode_fwd": K2_PER_FORWARD}
CLIP_PER_STEP = {"flash_attention_fwd": 1, "flash_attention_bwd": 1,
                 "grid4d_encode_fwd": K2_PER_FORWARD,
                 "hash_encode_bwd": K2_BWD_PER_STEP}
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
FLAGSHIP_PER_FORWARD = {"flash_attention_fwd": 2,
                        "grid4d_encode_fwd": K2_PER_FORWARD}
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
    "grid4d_encode_fwd": K2_PER_FORWARD, "hash_encode_bwd": K2_BWD_PER_STEP}
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
# the batches tried for the train step at 4608 patches, largest first,
# without activation checkpointing and then with every modality's
# encoder_remat and fusion.remat at 'full'
CLIP_SEARCH_BATCHES = (128, 96, 64, 48, 32, 24, 16, 12, 8, 4, 2, 1)
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
# the embedding service (phase 19): the README's quick start (api.DeepEarth's
# defaults: hidden 256, 4 fusion layers, Grid4D 8 + 4 levels on 2^15
# tables, bf16 compute), then the API at the A-stack's width (hidden 768,
# 12 fusion layers) with the quick start's two sources: a batch job of
# API_BATCH observations, API_REQUESTS single predicts, as many REST
# requests; times are host wall, synchronised, the median of API_REPEATS
# batch calls. Each request has SERVICE_TOKENS tokens (CLS, spacetime,
# species, temperature), so the fusion stack runs token-major: one K2-fwd
# and k1_per_forward K1-fwd launches a request, K1-fwd on the route
# k1_fwd_counter names (4 tokens: one warp a (row, head); the streaming
# route takes at most 3). Kernel vs plain path at phase 4's SLICE_TOL over
# the embedding and every reconstruction.
SERVICE_TOKENS = 4
QUICK_START = {"location": (28.5, -81.4), "time": "2024-06-15",
               "data": {"temperature": [22.3], "species": 17}}
API_BATCH, API_REQUESTS, API_REPEATS = 4096, 8, 5

# phase 20: the training CLI at the A-stack's width and batch (3 tokens:
# K1 on its streaming routes), and its --data-dir body at the published
# embedding widths (PERF.md section 1) over REAL_OBS observations
CLI_WIDTH = ["--hidden-dim", "768", "--n-layers", "12"]
CLI_BATCH, CLI_STEPS, CLI_LOG_EVERY = 4096, 8, 4
CLI_PER_STEP = {"pairwise_attention_fwd": 16, "pairwise_attention_bwd": 16,
                "grid4d_encode_fwd": 1, "hash_encode_bwd": 2}
CLI_PINNED_PER_BATCH = 2  # xyzt and species
REAL_OBS, REAL_BATCH, REAL_STEPS = 512, 64, 10
VISION_STORE_SHAPE, LANGUAGE_STORE_SHAPE = (576, 1408), (7168,)
CLI_DIR = Path(__file__).resolve().parent / "build" / "cli"
API_WIDTH = {"hidden_dim": 768, "n_layers": 12}

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
         mock.patch.object(grid4d_model, "grid4d_encode",
                           grid4d_encode.grid4d_encode_plain), \
         mock.patch.object(fusion, "pairwise_token_attention",
                           attention_smallseq.pairwise_token_attention_plain), \
         mock.patch.object(attention_vmem, "vmem_attention",
                           attention_vmem.vmem_attention_plain), \
         mock.patch.object(flash_attention, "flash_attention",
                           flash_attention.flash_attention_plain), \
         mock.patch.object(grouped_matmul, "gmm", grouped_matmul.gmm_plain), \
         mock.patch.object(kernels, "int8_bmm", quant.int8_bmm_plain), \
         mock.patch.object(kernels, "int4_bmm", quant.int4_bmm_plain), \
         mock.patch.object(splat, "composite", splat.composite_plain), \
         mock.patch.object(kernels, "splat_bin", splat.bin_tiles_plain):
        yield


@contextlib.contextmanager
def plain_versions_refused():
    """Make every plain version raise: a run inside reaches none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")
    with mock.patch.object(hash_encoding, "hash_encode_plain", refuse), \
         mock.patch.object(hash_encoding, "hash_encode_bwd_plain", refuse), \
         mock.patch.object(grid4d_encode, "grid4d_encode_plain", refuse), \
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
         mock.patch.object(quant, "int4_bmm_plain", refuse), \
         mock.patch.object(splat, "bin_tiles_plain", refuse), \
         mock.patch.object(splat, "composite_plain", refuse), \
         mock.patch.object(splat, "composite_bwd_plain", refuse):
        yield


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    print(f"[1 device+build] {card()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in {seconds:.2f} s: {lib.name}")
    log = lib.with_name(lib.name + ".log").read_text()
    print("    nvcc seconds by source: " + ", ".join(
        line[3:] for line in log.splitlines() if line.startswith("== ")))
    for line in ptxas_summary(log):
        print(f"    ptxas: {line}")


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    for i, width in itertools.product(range(len(mangled)), (1, 2, 3)):
        digits = mangled[i:i + width]  # a <length><name> piece
        if not digits.isdigit():
            continue
        name = mangled[i + width:i + width + int(digits)]
        if name[:1].isalpha() and name.endswith("_kernel"):
            break
    else:
        return mangled
    args = re.findall(r"L([ib])(\d+)E", mangled[i + width + len(name):])
    return name + ("<" + ",".join(
        ("true" if v == "1" else "false") if t == "b" else v
        for t, v in args) + ">" if args else "")


def ptxas_summary(log: str) -> list:
    """From the compiler's report: each kernel that spills (registers,
    bytes stored and loaded) and each whose wgmma the compiler serialised
    (C7515), one line each."""
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current and (int(m.group(1)) or int(m.group(2))):
            out.append(f"{kernel_label(current)} spills {m.group(1)} B "
                       f"stored, {m.group(2)} B loaded")
        m = re.search(r"\(C7515\).*function '(\S+)'", line)
        if m:
            out.append(f"{kernel_label(m.group(1))} wgmma serialised (C7515)")
    return sorted(set(out))


def _hash_case(gen, n, levels, table, d, f=2, interpolation="linear",
               table_size=None) -> tuple:
    """One table through the per-table kernel and its plain version: (max
    abs error, the kernel's launches read from its counter, which must be
    1)."""
    coords = torch.rand((n, d), generator=gen, device="cuda")
    # exact grid points of every level (multiples of 1/16) and the edges
    coords[: n // 8] = torch.randint(0, 17, (n // 8, d), generator=gen,
                                     device="cuda").float() / 16
    coords[0], coords[1] = 0.0, 1.0
    tables = torch.empty((levels, table, f), device="cuda").uniform_(
        -1e-4, 1e-4, generator=gen)
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device="cuda")
    kw = dict(interpolation=interpolation, table_size=table_size)
    kernels.reset_launch_counts()
    out = hash_encoding.hash_encode(coords, tables, res, **kw)
    torch.cuda.synchronize()
    launches = kernels.launch_counts["hash_encode_fwd"]
    if kernels.launch_counts != expected_launches(hash_encode_fwd=1):
        raise AssertionError(f"per-table K2-fwd: launches "
                             f"{kernels.launch_counts}")
    ref = hash_encoding.hash_encode_plain(coords, tables, res, **kw)
    if out.shape != (n, levels * f) or ref.shape != out.shape:
        raise AssertionError(f"K2 output shape {tuple(out.shape)}")
    return max_err(out, ref), launches


def grid4d_tables(gen, grid4d: Grid4DConfig):
    """A Grid4D encoder's tables (drawn as the model draws them),
    resolutions and configs on the card, in grid4d_encode.TABLES order."""
    cfgs = [grid4d.spatial, grid4d.temporal]
    if grid4d.use_decompositions:
        cfgs += [grid4d.decomposition] * len(grid4d_encode.DECOMPOSITIONS)
    tables = [hash_encoding.init_hash_tables(c, generator=gen, device="cuda")
              for c in cfgs]
    res = [torch.tensor(c.resolutions, dtype=torch.float32, device="cuda")
           for c in cfgs]
    return tables, res, cfgs


def grid4d_inputs(gen, n, masks, strided=False):
    """xyzt (N, 4) with exact grid points of every level (multiples of
    1/16) and the edges 0 and 1, a (N, 8) tensor's odd columns with
    ``strided``; with ``masks`` a spatial and a temporal (N,) bool mask,
    "all-False" for masks that are False everywhere."""
    xyzt = torch.rand((n, 8 if strided else 4), generator=gen, device="cuda")
    xyzt = xyzt[:, 1::2] if strided else xyzt
    k = max(n // 8, 1)
    xyzt[:k] = torch.randint(0, 17, (k, 4), generator=gen,
                             device="cuda").float() / 16
    xyzt[0] = 0.0
    if n > 1:
        xyzt[1] = 1.0
    if not masks:
        return xyzt, None, None
    sm, tm = (torch.rand(n, generator=gen, device="cuda") > 0.3
              for _ in range(2))
    if masks == "all-False":
        sm, tm = torch.zeros_like(sm), torch.zeros_like(tm)
    return xyzt, sm, tm


# Grid4D encodes held bit for bit against the plain composition (phase 2):
# name: (Grid4DConfig, N, compute dtype, masks, xyzt strided)
def grid4d_cases() -> dict:
    astack = astack_config().grid4d
    decomp = Grid4DConfig(n_spatial_levels=16, n_temporal_levels=8,
                          hash_table_size=2 ** 19, use_decompositions=True)
    # nearest corners, a table size no power of two, level counts that do
    # not divide 32 (each lane loads its point's coordinates itself)
    odd = Grid4DConfig(
        spatial=HashEncodingConfig(n_levels=12, hash_table_size=3001,
                                   coords_dim=3, interpolation="nearest"),
        temporal=HashEncodingConfig(n_levels=5, hash_table_size=1024,
                                    coords_dim=1, base_resolution=4,
                                    finest_resolution=300))
    bf16, fp32 = torch.bfloat16, torch.float32
    return {
        "A-stack B=4096 bf16": (astack, 4096, bf16, None, False),
        "A-stack B=4096 bf16 masked": (astack, 4096, bf16, "partial", False),
        "A-stack B=4096 fp32 masked": (astack, 4096, fp32, "partial", False),
        "A-stack B=4096 bf16 all-False": (astack, 4096, bf16, "all-False",
                                          False),
        "A-stack B=4096 bf16 xyzt strided": (astack, 4096, bf16, "partial",
                                             True),
        "A-stack B=1 bf16 masked": (astack, 1, bf16, "partial", False),
        "A-stack B=37 fp32": (astack, 37, fp32, None, True),
        "decompositions B=1000 bf16 masked": (decomp, 1000, bf16, "partial",
                                              False),
        "decompositions B=1000 fp32": (decomp, 1000, fp32, None, False),
        "nearest T=3001 L12/5 B=777 fp32 masked": (odd, 777, fp32, "partial",
                                                   True),
        "nearest T=3001 L12/5 B=777 bf16": (odd, 777, bf16, None, False),
    }


def _grid4d_case(gen, grid4d, n, dtype, masks, strided):
    """One Grid4D encode through the dispatch, twice, and the plain
    composition: (max abs error, both runs bitwise equal to the plain
    version, the fused kernel's launches read from its counter, which must
    be 2)."""
    tables, res, cfgs = grid4d_tables(gen, grid4d)
    xyzt, sm, tm = grid4d_inputs(gen, n, masks, strided)
    kernels.reset_launch_counts()
    out, again = (grid4d_encode.grid4d_encode(xyzt, tables, res, cfgs, sm, tm,
                                              out_dtype=dtype)
                  for _ in range(2))
    torch.cuda.synchronize()
    launches = kernels.launch_counts["grid4d_encode_fwd"]
    if kernels.launch_counts != expected_launches(grid4d_encode_fwd=2):
        raise AssertionError(f"K2-fwd Grid4D encode: launches "
                             f"{kernels.launch_counts}")
    ref = grid4d_encode.grid4d_encode_plain(xyzt, tables, res, cfgs, sm, tm,
                                            out_dtype=dtype)
    if out.shape != (n, grid4d.output_dim) or out.dtype != dtype \
            or ref.shape != out.shape:
        raise AssertionError(f"K2-fwd Grid4D encode: output "
                             f"{tuple(out.shape)} {out.dtype}")
    return (max_err(out, ref),
            torch.equal(out, ref) and torch.equal(again, ref), launches)


def phase_hash(gen) -> dict:
    """K2-fwd: the Grid4D encode (every table, masks, concatenation and
    cast in one launch) bit for bit against the plain composition, the
    route rule, the per-table kernel against its plain version; times of
    the whole encode (one launch, the per-table composition, the plain
    version) at the A-stack's B=4096 with and without masks, the multimodal
    B=512 and B=1, and of the spatial and temporal tables alone on the
    per-table kernel."""
    # launches read from the counters in the checks below, before any
    # timing launches a kernel again
    errs, repeat, launches = {}, {}, collections.Counter()
    for name, case in grid4d_cases().items():
        errs[name], repeat[name], count = _grid4d_case(gen, *case)
        launches["grid4d_encode_fwd"] += count
    if max(errs.values()) > HASH_TOL or not all(repeat.values()):
        raise AssertionError(f"K2-fwd Grid4D encode vs plain {errs}, both "
                             f"runs bitwise equal to plain {repeat}")
    # the route rule: F = 3 takes the per-table kernel
    f3 = Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                      n_features_per_level=3, hash_table_size=4096)
    tables, res, cfgs = grid4d_tables(gen, f3)
    xyzt, sm, tm = grid4d_inputs(gen, 512, "partial")
    kernels.reset_launch_counts()
    out = grid4d_encode.grid4d_encode(xyzt, tables, res, cfgs, sm, tm,
                                      out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if kernels.launch_counts != expected_launches(hash_encode_fwd=2):
        raise AssertionError(f"F = 3: launches {kernels.launch_counts}")
    launches["hash_encode_fwd"] += kernels.launch_counts["hash_encode_fwd"]
    errs["F=3 per-table route"] = max_err(
        out, grid4d_encode.grid4d_encode_plain(xyzt, tables, res, cfgs, sm,
                                               tm, out_dtype=torch.bfloat16))

    n = 4096
    table_cases = {
        "spatial L16 T2^19 D3": dict(levels=16, table=2 ** 19, d=3),
        "temporal L8 T2^17 D1": dict(levels=8, table=2 ** 17, d=1),
        "T=3001 D3": dict(levels=4, table=3001, d=3),
        "nearest D3": dict(levels=16, table=2 ** 19, d=3,
                           interpolation="nearest"),
        "D2 F3": dict(levels=4, table=4096, d=2, f=3),
        "D4 hashed into 1000 of 1024": dict(levels=4, table=1024, d=4,
                                            table_size=1000),
    }
    table_errs = {}
    for name, kw in table_cases.items():
        table_errs[name], count = _hash_case(gen, n, **kw)
        launches["hash_encode_fwd"] += count
    errs.update({f"per-table {k}": v for k, v in table_errs.items()})
    worst = max(errs.values())
    if worst > HASH_TOL:
        raise AssertionError(f"K2-fwd disagrees with its plain version: "
                             f"{errs}")

    # times over 16 coordinate sets cycled in a CUDA graph, so that the
    # fine levels' rows are not all in L2 from the previous call
    tables, res, cfgs = grid4d_tables(gen, astack_config().grid4d)

    def encode(label, xyzt, sm, tm):
        args = (xyzt, tables, res, cfgs, sm, tm)
        if label == "composition":  # the per-table kernel, torch around it
            return grid4d_encode._compose(hash_encoding.hash_encode, *args,
                                          torch.bfloat16)
        fn = (grid4d_encode.grid4d_encode if label == "fused"
              else grid4d_encode.grid4d_encode_plain)
        return fn(*args, out_dtype=torch.bfloat16)

    times, bounds = {}, {}
    for size, n, masks in (("B=4096", 4096, None),
                           ("B=4096 masked", 4096, "partial"),
                           ("B=512", MM_BATCH, None), ("B=1", 1, None)):
        pool = [grid4d_inputs(gen, n, masks) for _ in range(16)]
        bounds[size] = grid4d_bounds(pool, tables, res, cfgs, torch.bfloat16)
        for label in ("fused", "composition", "plain", "plain",
                      "composition", "fused"):
            inputs = itertools.cycle(pool)
            times.setdefault(size, {}).setdefault(label, []).append(
                graph_ms(lambda: encode(label, *next(inputs))))
    # each table alone on the per-table kernel and its plain version, fp32 out
    table_times, table_bounds = {}, {}
    for i, name in enumerate(("spatial", "temporal")):
        xyzts = [torch.rand((4096, 4), generator=gen, device="cuda")
                 for _ in range(16)]
        table_bounds[name] = grid4d_bounds(
            [(x, None, None) for x in xyzts], tables[i:i + 1],
            res[i:i + 1], cfgs[i:i + 1], torch.float32, first=i)
        pool = [grid4d_encode._columns(x, grid4d_encode.TABLES[i][1])
                for x in xyzts]
        for label, fn in (("kernel", hash_encoding.hash_encode),
                          ("plain", hash_encoding.hash_encode_plain)):
            coords = itertools.cycle(pool)
            table_times[f"{name}_{label}"] = graph_ms(
                lambda: fn(next(coords), tables[i], res[i]))
    best = {size: {k: min(v) for k, v in t.items()}
            for size, t in times.items()}
    main = best["B=4096"]
    print(f"[2 K2-fwd grid4d_encode_fwd] bit for bit against the plain "
          f"composition: max_abs_err {worst:.3g} (tol {HASH_TOL}) over "
          f"{len(errs)} cases (per case: " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + "), two runs bitwise equal to the plain version on every Grid4D "
          "case; F = 3 took "
          "the per-table kernel | whole encode xyzt -> combined (bf16), ms "
          "in CUDA graphs over 16 coordinate sets, one launch / the "
          "per-table composition / plain: " + "; ".join(
              f"{size} {t['fused']:.4f} / {t['composition']:.4f} / "
              f"{t['plain']:.4f} (bound {bounds[size]['bound_ms']:.4f}, "
              f"design's floor {bounds[size]['floor_ms']:.4f})"
              for size, t in best.items())
          + " | a table alone at B=4096 (fp32 out), the per-table kernel / "
          "plain: "
          + "; ".join(f"{name} {table_times[name + '_kernel']:.4f} / "
                      f"{table_times[name + '_plain']:.4f} (bound "
                      f"{b['bound_ms']:.4f}, design's floor "
                      f"{b['floor_ms']:.4f})"
                      for name, b in table_bounds.items())
          + " | every timing: "
          + json.dumps(times) + f" | {card()}")
    return {"max_abs_err": worst, "ms": main["fused"],
            "plain_ms": main["plain"], "library_ms": None,
            "composition_ms": main["composition"],
            "floor_ms": bounds["B=4096"]["floor_ms"],
            "table_times": table_times, "table_bounds": table_bounds,
            "per_table_max_abs_err": max(table_errs.values()),
            "times": best, "bounds": bounds,
            "launches": dict(launches),
            **{k: bounds["B=4096"][k] for k in ("bound_ms", "bound_by")}}


def grid4d_bounds(pool, tables, res, cfgs, dtype, first: int = 0) -> dict:
    """Mean over the pool of one encode's bound (the coordinates and the
    masks in, the distinct table rows its points touch, 8 bytes each, read
    once, the output in ``dtype`` out; or its operations) and of its
    design's floor (the distinct 32-byte sectors of those rows instead of
    the rows). The tables are grid4d_encode.TABLES' from ``first`` on."""
    layout = grid4d_encode.TABLES[first:first + len(tables)]
    n_cols = len({c for _, cols, _ in layout for c in cols})
    bound_ms, floor_ms = [], []
    for xyzt, sm, tm in pool:
        n = xyzt.shape[0]
        rows = sectors = corners = 0
        for (_, cols, _), t, r, cfg in zip(layout, tables, res, cfgs):
            levels, table, feats = t.shape
            idx = torch.cat([i.flatten() for i, _ in
                             hash_encoding._cell_corners(
                                 grid4d_encode._columns(xyzt, cols), r,
                                 levels, table, cfg.hash_table_size,
                                 cfg.interpolation)])
            rows += idx.unique().numel()
            sectors += (idx * feats * 4 // 32).unique().numel()
            corners += idx.numel()
        out_dim = sum(t.shape[0] * t.shape[2] for t in tables)
        edge = (n * n_cols * 4
                + nbytes(*(m for m in (sm, tm) if m is not None))
                + n * out_dim * torch.finfo(dtype).bits // 8)
        flops = 4 * corners  # a multiply and an add a corner and feature
        bound_ms.append(bound(edge + 8 * rows, flops, torch.float32))
        floor_ms.append(bound(edge + 32 * sectors, flops, torch.float32))
    return {"bound_ms": sum(b["bound_ms"] for b in bound_ms) / len(pool),
            "bound_by": bound_ms[0]["bound_by"],
            "floor_ms": sum(b["bound_ms"] for b in floor_ms) / len(pool)}


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
            want = expected_launches(grid4d_encode_fwd=2 * K2_PER_FORWARD,
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
        grid4d_encode_fwd=K2_PER_FORWARD * (TRAIN_STEPS + 2),
        hash_encode_bwd=K2_BWD_PER_STEP * TRAIN_STEPS,
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
    want = expected_launches(grid4d_encode_fwd=2 * K2_PER_FORWARD,
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
          f"{K3_PER_FORWARD} K2 {K2_PER_FORWARD} K1 0, no plain version "
          "reached (routes "
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
                causal=False, chunk=None, dim=0) -> tuple:
    """K4-fwd's (out, lse) and K4-bwd's grads on one case against the plain
    versions, run ``chunk`` batch rows (``dim`` 0) or heads (``dim`` 1) at
    a time (the plain version holds (B, H, N, N) fp32 scores of the chunk);
    an all-masked row's output must be 0. Returns the largest output error,
    the mean output error over the mean |plain|, and the largest gradient
    error."""
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal)
    chunk = chunk or q.shape[dim]
    parts = []
    for i in range(0, q.shape[dim], chunk):
        at = (slice(None),) * dim + (slice(i, i + chunk),)
        mask = key_mask if key_mask is None or dim else key_mask[at]
        ref, ref_lse = flash_attention.flash_attention_plain(
            q[at], k[at], v[at], return_lse=True, key_mask=mask, **kw)
        parts.append((ref, ref_lse, *flash_attention.flash_attention_bwd_plain(
            q[at], k[at], v[at], out[at], lse[at], do[at],
            key_mask=mask, **kw)))
    ref, ref_lse, *ref_grads = (torch.cat(x, dim=dim) for x in zip(*parts))
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


# Phase 21's K4 shapes at heads wider than 128: name -> (B, H, N, Dqk, Dv,
# key mask, causal, heads the plain version takes at a time). Timed: the
# classifier's MLA at DeepSeek-V3's widths over 4096 tokens (128 heads of
# 192 / 128) and 256 / 256 over a V-JEPA2 clip; checked besides: masked
# and causal tiles at both widths, and widths between (200 / 136: partial
# panels of the 256 / 256 tiles; 190 / 126: off TMA's grid, the mma.sync
# route)
WIDE_FLASH_TIMED = {"V3 MLA 192/128": (1, 128, 4096, 192, 128),
                    "256/256": (8, 8, CLIP_PATCHES, 256, 256)}
WIDE_FLASH_CASES = {
    "V3 MLA 192/128": (1, 128, 4096, 192, 128, False, False, 16),
    "256/256": (8, 8, CLIP_PATCHES, 256, 256, False, False, 2),
    "masked causal N=1500 192/128": (2, 4, 1500, 192, 128, True, True, 4),
    "masked N=1000 256/256": (2, 4, 1000, 256, 256, True, False, 4),
    "Dqk200 Dv136 N=700": (2, 2, 700, 200, 136, False, False, 2),
    "Dqk190 Dv126 N=700": (2, 2, 700, 190, 126, True, False, 2),
}


def phase_wide_flash(gen) -> dict:
    """Phase 21 (a): K4-fwd and K4-bwd at head dims above 128 on each route
    against the plain versions, and timed at WIDE_FLASH_TIMED."""
    torch.cuda.empty_cache()
    errs, routes = {}, {}
    worst = collections.Counter()
    route_launches = collections.Counter()
    timing = {}
    for name, (b, h, n, dqk, dv, mask, causal, heads) in \
            WIDE_FLASH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, key_mask = attention_case(gen, b, h, n, n, dqk, dv,
                                                   dtype, mask)
            sc = dqk ** -0.5
            route = attention_route(q, k, v)
            runs = {route: (kernels.flash_attention_fwd,
                            kernels.flash_attention_bwd)}
            if route == "":  # bf16 on the grid: the mma.sync route too
                runs["_mma"] = (kernels.flash_attention_fwd_mma,
                                kernels.flash_attention_bwd_mma)
            for rt, (fwd, bwd) in runs.items():
                key = f"{name} {str(dtype).split('.')[-1]} {rt or 'TMA'}"
                kernels.reset_launch_counts()
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)]
                marks[0].record()
                out, lse = fwd(q, k, v, sc, key_mask, causal)
                marks[1].record()
                got = bwd(q, k, v, out, lse, do, sc, key_mask, causal)
                marks[2].record()
                want = expected_launches(**{f"flash_attention_fwd{rt}": 1,
                                            f"flash_attention_bwd{rt}": 1})
                if kernels.launch_counts != want:
                    raise AssertionError(f"K4 {key}: launches "
                                         f"{kernels.launch_counts} != {want}")
                route_launches.update({x: c for x, c in
                                       kernels.launch_counts.items() if c})
                routes[key] = rt or "TMA"
                errs[key] = check_flash(key, q, k, v, do, out, lse, got,
                                        key_mask, causal, chunk=heads, dim=1)
                for d, e in zip(("fwd", "bwd"), (errs[key][0], errs[key][2])):
                    worst[(d, rt, name in WIDE_FLASH_TIMED)] = max(
                        worst[(d, rt, name in WIDE_FLASH_TIMED)], e)
                if name in WIDE_FLASH_TIMED:
                    t = timing.setdefault(name, {"fwd": {}, "bwd": {}})
                    tag = {"": "ms", "_mma": "mma_ms", "_fp32": "fp32_ms"}[rt]
                    if rt == "_fp32":  # ~1-7 s a call: the checked call's
                        marks[2].synchronize()
                        t["fwd"][tag] = marks[0].elapsed_time(marks[1])
                        t["bwd"][tag] = marks[1].elapsed_time(marks[2])
                    else:
                        iters = 5 if rt == "" else 1
                        t["fwd"][tag] = cuda_ms(
                            lambda: fwd(q, k, v, sc), iters=iters, warmup=1)
                        t["bwd"][tag] = cuda_ms(
                            lambda: bwd(q, k, v, out, lse, do, sc),
                            iters=iters, warmup=1)
                    if rt == "":
                        pairs = n * n
                        t["fwd"].update(bound(nbytes(q, k, v, out, lse),
                                              2 * b * h * pairs * (dqk + dv),
                                              dtype))
                        t["bwd"].update(bound(
                            nbytes(q, k, v, out, lse, do, q, k, v),
                            attn_bwd_flops(b, h, pairs, dqk, dv), dtype))
                        t["fwd"]["library_ms"] = library_fwd_ms(q, k, v, sc)
                        t["bwd"]["library_ms"] = library_bwd_ms(q, k, v, do,
                                                                sc)
                        t["fwd"]["plain_ms"], t["bwd"]["plain_ms"] = (
                            plain_heads_ms(q, k, v, out, lse, do, sc, heads))
                del out, lse, got
            del q, k, v, do, key_mask
            torch.cuda.empty_cache()

    def row(t):
        return (f"TMA {t['ms']:.3f}, mma.sync {t['mma_ms']:.3f}, fp32 "
                f"{t['fp32_ms']:.3f}, plain (bf16, by head chunks) "
                f"{t['plain_ms']:.3f}, library {fmt(t['library_ms'])}, "
                f"bound {t['bound_ms']:.3f} ({t['bound_by']})")
    print("[21a K4 at heads above 128] routes per case (TMA = wgmma over TMA "
          "tiles): " + ", ".join(f"{x} {r}" for x, r in routes.items())
          + " | max_abs_err (out, mean over mean |plain|, grads) "
          + ", ".join(f"{x} {e[0]:.3g}/{e[1]:.3g}/{e[2]:.3g}"
                      for x, e in errs.items())
          + f" (tol fp32 {VMEM_TOL[torch.float32]}, bf16 {K4_MAX_REL} of the "
          f"largest entry; grads {tags(BWD_TOL)} of each gradient's largest "
          "entry) | ms (device, CUDA events; library = "
          "scaled_dot_product_attention): " + "; ".join(
              f"{x} B={WIDE_FLASH_TIMED[x][0]} H={WIDE_FLASH_TIMED[x][1]} "
              f"N={WIDE_FLASH_TIMED[x][2]} fwd {row(t['fwd'])}, bwd "
              f"{row(t['bwd'])}" for x, t in timing.items())
          + f" | launches {dict(route_launches)} | {card()}")
    out = {}
    for x, t in timing.items():
        for d in ("fwd", "bwd"):
            out.setdefault(d, {})[x] = {
                **t[d], "max_abs_err": worst[(d, "", True)],
                "mma_max_abs_err": worst[(d, "_mma", True)],
                "fp32_max_abs_err": worst[(d, "_fp32", True)]}
    out["launches"] = dict(route_launches)
    return out


def plain_heads_ms(q, k, v, out, lse, do, scale, heads) -> tuple:
    """Device ms of the plain K4-fwd and K4-bwd over all of q's heads,
    ``heads`` at a time (the whole tensors' fp32 scores would not fit)."""
    def run(fn):
        for i in range(0, q.shape[1], heads):
            at = (slice(None), slice(i, i + heads))
            fn(at)
    fwd = cuda_ms(lambda: run(lambda at: flash_attention.flash_attention_plain(
        q[at], k[at], v[at], scale=scale)), iters=1, warmup=1)
    bwd = cuda_ms(lambda: run(
        lambda at: flash_attention.flash_attention_bwd_plain(
            q[at], k[at], v[at], out[at], lse[at], do[at], scale=scale)),
        iters=1, warmup=1)
    return fwd, bwd


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
          f"{counted}, as expected: per forward K4-fwd 2, K2-fwd 1, K5 "
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
    activation checkpointing and then with every modality's encoder_remat
    and fusion.remat at 'full': for each, the largest batch of
    CLIP_SEARCH_BATCHES that fits on the card, its step time, peak memory
    and dispatch modes."""
    found = {}
    for policy in (None, "full"):
        free_cuda()
        cfg = flagship_train_config()
        set_remat_config(cfg, policy)
        model = DeepEarthModel(cfg, generator=gen, device=gen.device,
                               native_seq_lens={"vision": CLIP_PATCHES,
                                                "language": 16})
        trainer = Trainer(model, cfg, FLAGSHIP_TRAIN_WEIGHTS, seed=SEED)
        what = ("no activation checkpointing" if policy is None else
                f"encoder_remat and fusion.remat at '{policy}'")
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
            batch = make_flagship_batch(gen, b, CLIP_PATCHES)
            timing.update(step_peaks(trainer, batch))
            del batch
            free_cuda()
            found[policy] = (b, timing)
            print(f"[clip batch search] flagship train step at "
                  f"{CLIP_PATCHES} patches, {what}: "
                  + "; ".join(tried + [f"B={b} fits"])
                  + f" | B={b}: step ms eager (CUDA events over 2 steps) "
                  f"{turns(timing)}, {b / timing['step_ms'] * 1e3:.2f} "
                  f"obs/s, peak mem {timing['peak_gib']:.2f} GiB (one step "
                  f"from a fresh state: {timing['step_gib']:.2f} GiB, its "
                  f"forward and backward {timing['fwd_bwd_gib']:.2f} GiB) "
                  "| dispatch "
                  "modes: " + ", ".join(f"{k} {v}" for k, v in
                                        site_modes(model).items())
                  + f" | {card()}")
            break
        del model, trainer
        if policy not in found:
            raise AssertionError(f"{what}: no batch fits: {tried}")
    (b0, t0), (b1, t1) = found[None], found["full"]
    print(f"[clip batch search] largest batch without remat B={b0} "
          f"({t0['step_ms']:.1f} ms a step, {t0['peak_gib']:.2f} GiB; forward "
          f"and backward {t0['fwd_bwd_gib']:.2f}), with remat 'full' B={b1} "
          f"({t1['step_ms']:.1f} ms a step, {t1['peak_gib']:.2f} GiB; forward"
          f" and backward {t1['fwd_bwd_gib']:.2f}) | {card()}")


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


def k1_per_forward(fusion_cfg) -> int:
    """K1-fwd launches of a token-major forward: the self-attention of
    every fusion layer and the cross-attention of every
    ``cross_attention_freq``-th, from layer 0."""
    n = fusion_cfg.num_fusion_layers
    return n + len(range(0, n, fusion_cfg.cross_attention_freq))


def k1_fwd_counter(n_tokens: int) -> str:
    """The launch counter of K1-fwd's route in a token-major bf16 stack of
    ``n_tokens`` tokens (head dims and strides on the 8-element grid): the
    streaming route up to kernels.PAIRWISE_TMA_MAX_TOKENS, else one warp a
    (row, head)."""
    if n_tokens <= kernels.PAIRWISE_TMA_MAX_TOKENS:
        return "pairwise_attention_fwd"
    return "pairwise_attention_fwd_warp"


def register_quick_start(earth: DeepEarth) -> DeepEarth:
    earth.register("temperature", shape=(1,), type="numerical")
    earth.register("species", type="categorical", num_classes=232)
    return earth


def api_requests(seed: int, n: int) -> list:
    """``n`` single requests (location with altitude, ISO time, both
    sources), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [{"location": (float(rng.uniform(-90, 90)),
                          float(rng.uniform(-180, 180)),
                          float(rng.uniform(0, 3000))),
             "time": f"{int(rng.integers(2000, 2050))}-"
                     f"{int(rng.integers(1, 13)):02d}-15",
             "data": {"temperature": [float(rng.normal(15, 10))],
                      "species": int(rng.integers(0, 232))}}
            for _ in range(n)]


def api_batch(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"locations": np.stack([rng.uniform(-90, 90, n),
                                   rng.uniform(-180, 180, n),
                                   rng.uniform(0, 3000, n)], axis=-1),
            "times": list(rng.uniform(0, 1, n)),
            "data": {"temperature": rng.normal(15, 10, (n, 1)),
                     "species": rng.integers(0, 232, n)}}


def api_diff(pairs) -> dict:
    """Max and mean absolute difference over (kernel, plain) numpy pairs."""
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
    return {"max_abs": float(diff.max()), "mean_abs": float(diff.mean())}


def wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def counted(fn, want: dict, what: str):
    """``fn()`` with every launch count set to 0 before and read after,
    no plain version reachable; the counts must be ``want``."""
    kernels.reset_launch_counts()
    with plain_versions_refused():
        out = fn()
    torch.cuda.synchronize()
    got = dict(kernels.launch_counts)
    if got != expected_launches(**want):
        raise AssertionError(f"{what}: launches {got} != {want}")
    return out, got


def service_kernels(gen, grid4d: Grid4DConfig) -> dict:
    """The service path's two kernels at its shapes, held against their
    plain versions and timed: K2-fwd at the API's Grid4D (B=4096 and B=1,
    bf16 out, bit for bit) and K1-fwd by its route at SERVICE_TOKENS tokens
    ((4, 4096, 768) of 12 heads, the A-stack width's; (4, 1, 256) of 4, the
    quick start's), each twice bitwise equal; times by CUDA-graph replays
    in turns at B=4096, beside the plain versions, the library (K1-fwd:
    scaled_dot_product_attention) and the bound."""
    k2 = {f"B={n}": _grid4d_case(gen, grid4d, n, torch.bfloat16, None, False)
          for n in (API_BATCH, 1)}
    if not all(bitwise for _, bitwise, _ in k2.values()):
        raise AssertionError(f"K2-fwd at the API's Grid4D: {k2}")
    tables, res, cfgs = grid4d_tables(gen, grid4d)
    pool = [grid4d_inputs(gen, API_BATCH, None) for _ in range(16)]
    k2_times = {}
    for label, fn in (("kernel", grid4d_encode.grid4d_encode),
                      ("plain", grid4d_encode.grid4d_encode_plain),
                      ("plain", grid4d_encode.grid4d_encode_plain),
                      ("kernel", grid4d_encode.grid4d_encode)):
        inputs = itertools.cycle(pool)
        k2_times.setdefault(label, []).append(graph_ms(
            lambda: fn(next(inputs)[0], tables, res, cfgs,
                       out_dtype=torch.bfloat16)))

    k1, counter = {}, k1_fwd_counter(SERVICE_TOKENS)
    for tag, b, d, h in ((f"B={API_BATCH}", API_BATCH, 768, 12),
                         ("B=1", 1, 256, 4)):
        q, k, v = k1_inputs(gen, SERVICE_TOKENS, SERVICE_TOKENS, b, d,
                            torch.bfloat16)
        kw = dict(n_heads=h, scale=(d // h) ** -0.5)
        if k1_route(q, k, v, h, "fwd") != counter:
            raise AssertionError(f"K1-fwd {tag}: not on {counter}")
        kernels.reset_launch_counts()
        out, again = (attention_smallseq.pairwise_token_attention(q, k, v,
                                                                  **kw)
                      for _ in range(2))
        torch.cuda.synchronize()
        if kernels.launch_counts != expected_launches(**{counter: 2}):
            raise AssertionError(f"K1-fwd {tag}: {kernels.launch_counts}")
        ref = attention_smallseq.pairwise_token_attention_plain(q, k, v,
                                                                **kw)
        k1[tag] = max_err(out, ref)
        if k1[tag] > ATTN_TOL[torch.bfloat16] or not torch.equal(out, again):
            raise AssertionError(f"K1-fwd {tag}: max_abs_err {k1[tag]} or "
                                 f"two runs differ")
    # q, k, v of the B=4096 case
    q, k, v = k1_inputs(gen, SERVICE_TOKENS, SERVICE_TOKENS, API_BATCH, 768,
                        torch.bfloat16)
    calls = {"kernel": lambda: attention_smallseq.pairwise_token_attention(
                 q, k, v, n_heads=12, scale=0.125),
             "plain": lambda: attention_smallseq.pairwise_token_attention_plain(
                 q, k, v, n_heads=12, scale=0.125)}
    k1_times = {}
    for label in ("kernel", "plain", "plain", "kernel"):
        k1_times.setdefault(label, []).append(graph_ms(calls[label]))
    qh, kh, vh = (bhnd(x, 12) for x in (q, k, v))
    k1_times["library"] = [graph_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=0.125))]
    n = SERVICE_TOKENS
    return {
        "grid4d_encode_fwd": {
            "max_abs_err": max(e for e, _, _ in k2.values()),
            "ms": min(k2_times["kernel"]), "plain_ms": min(k2_times["plain"]),
            **grid4d_bounds(pool, tables, res, cfgs, torch.bfloat16)},
        counter: {
            "max_abs_err": max(k1.values()), "errs": k1,
            "ms": min(k1_times["kernel"]), "plain_ms": min(k1_times["plain"]),
            "library_ms": k1_times["library"][0],
            **bound(nbytes(q, k, v, q), 4 * n * n * API_BATCH * 768,
                    torch.bfloat16)}}


def phase_service() -> dict:
    """The embedding service on the card through the user's entry points:
    api.DeepEarth (the README's quick start, then the A-stack's width), the
    REST DataService behind DashboardServer with DashboardClient, and save
    / load."""
    if k1_per_forward(astack_config().fusion) != K1_PER_FORWARD:
        raise AssertionError("k1_per_forward disagrees with phase 4")

    # the README's quick start, on the card by default
    earth = register_quick_start(DeepEarth())
    at_shapes = service_kernels(
        torch.Generator(device="cuda").manual_seed(SEED),
        earth._config.grid4d)
    k1 = k1_fwd_counter(SERVICE_TOKENS)
    quick, quick_launches = counted(
        lambda: earth.predict(**QUICK_START),
        {"grid4d_encode_fwd": K2_PER_FORWARD,
         k1: k1_per_forward(earth._config.fusion)},
        "the quick start's predict")
    if (quick.shape != (256,) or quick.dtype != np.float32
            or not np.isfinite(quick).all()):
        raise AssertionError(f"quick start: {quick.shape} {quick.dtype} or "
                             f"non-finite values")
    with plain_versions():
        quick_plain = earth.predict(**QUICK_START)
    quick_err = api_diff([(quick, quick_plain)])

    # the API at the A-stack's width: a batch job and single requests
    earth = register_quick_start(DeepEarth(**API_WIDTH))
    job = api_batch(SEED, API_BATCH)
    singles = api_requests(SEED + 1, API_REQUESTS)
    per_request = {"grid4d_encode_fwd": K2_PER_FORWARD, k1: K1_PER_FORWARD}
    n_calls = 1 + API_REQUESTS

    def serve():
        out = earth.predict_batch(**job, return_reconstructions=True)
        return out, [earth.predict(**r) for r in singles]
    (batch_out, single_out), api_launches = counted(
        serve, {k: n_calls * v for k, v in per_request.items()},
        "the API's batch job and single requests")
    emb, recon = batch_out
    shapes = {"embedding": (API_BATCH, API_WIDTH["hidden_dim"]),
              "spatial": (API_BATCH, 3),
              "temporal": (API_BATCH, 1), "species": (API_BATCH, 232),
              "temperature": (API_BATCH, 1)}
    for key, arr in {"embedding": emb, **recon}.items():
        if arr.shape != shapes[key] or not np.isfinite(arr).all():
            raise AssertionError(f"B={API_BATCH} {key}: {arr.shape} or "
                                 f"non-finite values")
    with plain_versions():
        ref_emb, ref_recon = earth.predict_batch(**job,
                                                 return_reconstructions=True)
        ref_single = [earth.predict(**r) for r in singles]
    errs = {f"B={API_BATCH}": api_diff(
                [(emb, ref_emb)] + [(recon[k], ref_recon[k]) for k in recon]),
            "single": api_diff(list(zip(single_out, ref_single)))}
    for tag, e in {"quick start": quick_err, **errs}.items():
        if any(e[k] > SLICE_TOL[k] for k in SLICE_TOL):
            raise AssertionError(f"API kernel vs plain path, {tag}: {e} (tol "
                                 f"{SLICE_TOL})")

    timing = {
        "batch_ms": statistics.median(
            wall_ms(lambda: earth.predict_batch(**job))
            for _ in range(API_REPEATS)),
        "predict_ms": statistics.median(
            wall_ms(lambda: earth.predict(**r)) for r in singles)}
    with plain_versions():
        timing["batch_plain_ms"] = statistics.median(
            wall_ms(lambda: earth.predict_batch(**job))
            for _ in range(API_REPEATS))
        timing["predict_plain_ms"] = statistics.median(
            wall_ms(lambda: earth.predict(**r)) for r in singles)

    # where a request's time goes: kernels by device time and launches
    profiles = {"predict_batch": kernel_breakdown(
                    lambda: earth.predict_batch(**job)),
                "predict": kernel_breakdown(
                    lambda: earth.predict(**singles[0]), n_calls=5)}
    for what, (breakdown, by_op) in profiles.items():
        timing[f"{what}_device_ms"] = sum(r[1] for r in breakdown)
        timing[f"{what}_launches"] = sum(r[2] for r in breakdown)
    print_breakdown(19, f"predict_batch B={API_BATCH}", "call",
                    *profiles["predict_batch"])
    print_breakdown(19, "one predict", "call", *profiles["predict"])

    # the REST path: each answer bit for bit the API's
    server = DashboardServer(DataService(predictor=earth), host="127.0.0.1",
                             port=0).start()
    try:
        client = DashboardClient(f"http://127.0.0.1:{server.port}")

        def ask():
            walls, answers = [], []
            for r in singles:
                t0 = time.perf_counter()
                answers.append(client.predict(r["location"], r["time"],
                                              r["data"]))
                walls.append((time.perf_counter() - t0) * 1e3)
            return walls, answers
        (rest_walls, answers), _ = counted(
            ask, {k: API_REQUESTS * v for k, v in per_request.items()},
            "the REST requests")
    finally:
        server.stop()
    for r, got in zip(singles, answers):
        if not np.array_equal(got, earth.predict(**r)):
            raise AssertionError("a REST answer differs from predict's")
    timing["rest_ms"] = statistics.median(rest_walls)

    # save -> load on the card: a fresh DeepEarth predicts the same bits
    path = Path(__file__).resolve().parent / "build" / "api_save"
    try:
        earth.save(str(path))
        loaded = DeepEarth(**API_WIDTH).load(str(path))
        same = np.array_equal(loaded.predict_batch(**job), emb) and all(
            np.array_equal(loaded.predict(**r), e)
            for r, e in zip(singles, single_out))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if not same:
        raise AssertionError("save -> load changed the predictions")
    n_params = sum(p.numel() for p in earth._model.parameters())
    print(f"[19 embedding service] the quick start (DeepEarth(), 4 layers): "
          f"shape {quick.shape} finite, launches K2 "
          f"{quick_launches['grid4d_encode_fwd']} K1 {quick_launches[k1]} "
          f"({k1}) | DeepEarth({API_WIDTH}), "
          f"{n_params / 1e6:.1f}M params: launches per request K2 "
          f"{K2_PER_FORWARD} K1 {K1_PER_FORWARD} over {n_calls} API calls "
          f"and {API_REQUESTS} REST requests, no plain version reached | "
          f"vs plain path: quick start max "
          f"{quick_err['max_abs']:.4g} mean {quick_err['mean_abs']:.3g}, "
          + ", ".join(f"{k} max {v['max_abs']:.4g} mean {v['mean_abs']:.3g}"
                      for k, v in errs.items())
          + f" (tol {SLICE_TOL}) | predict_batch B={API_BATCH} "
          f"{timing['batch_ms']:.3f} ms, "
          f"{API_BATCH / timing['batch_ms'] * 1e3:.0f} obs/s (plain "
          f"versions {timing['batch_plain_ms']:.3f} ms); "
          f"predict median {timing['predict_ms']:.3f} ms (plain "
          f"{timing['predict_plain_ms']:.3f}); kernels a call: "
          f"predict_batch {timing['predict_batch_device_ms']:.3f} ms in "
          f"{timing['predict_batch_launches']:.0f} launches, predict "
          f"{timing['predict_device_ms']:.3f} ms in "
          f"{timing['predict_launches']:.0f}; REST median "
          f"{timing['rest_ms']:.3f} ms, answers bit for bit predict's | "
          f"save -> load bit for bit | {card()}")
    k2s, k1s = at_shapes["grid4d_encode_fwd"], at_shapes[k1]
    print(f"[19 embedding service kernels] K2-fwd at the API's Grid4D (8 + 4 "
          f"levels on 2^15 tables, bf16): max_abs_err {k2s['max_abs_err']:.3g}"
          f" at B={API_BATCH} and B=1, two runs bitwise equal; B={API_BATCH} "
          f"{k2s['ms']:.4f} ms (plain {k2s['plain_ms']:.4f}; bound "
          f"{k2s['bound_ms']:.4f} {k2s['bound_by']}) | K1-fwd {k1} at "
          f"({SERVICE_TOKENS}, {API_BATCH}, 768) 12 heads and "
          f"({SERVICE_TOKENS}, 1, 256) 4 heads, bf16: max_abs_err "
          + ", ".join(f"{t} {e:.3g}" for t, e in k1s["errs"].items())
          + f" (tol {ATTN_TOL[torch.bfloat16]}), two runs bitwise equal; "
          f"B={API_BATCH} {k1s['ms']:.4f} ms (plain {k1s['plain_ms']:.4f}, "
          f"library {k1s['library_ms']:.4f}; bound {k1s['bound_ms']:.4f} "
          f"{k1s['bound_by']}) | CUDA-graph replays | {card()}")
    return {"launches": api_launches, "kernels": at_shapes}



class StepWatch:
    """Wraps the train step of every Trainer built inside :meth:`watching`:
    CUDA events around each step, its (loss, grad_norm), how many distinct
    batches the steps were given, and a check that every leaf of each batch
    lies on the card (the prefetch never leaves one on the host). ``after``
    is called after each step (a profiler's ``step``)."""

    def __init__(self, after=None):
        self.after = after
        self.events, self.metrics = [], []
        self.distinct, self._last = 0, None
        # host wall in each step's call, and from one call's end to the
        # next's start (the loop's next batch: data, prefetch, logging)
        self.host_in, self.host_between, self._left = [], [], None

    @contextlib.contextmanager
    def watching(self):
        make = trainer_module.make_train_step

        def make_watched(*args, **kwargs):
            step = make(*args, **kwargs)

            def watched(state, batch, generator):
                off = [type(x).__name__ for x in batch_leaves(batch)
                       if not (isinstance(x, torch.Tensor) and x.is_cuda)]
                if off:
                    raise AssertionError(f"batch leaves off the card: {off}")
                if batch is not self._last:
                    self.distinct, self._last = self.distinct + 1, batch
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                t0 = time.perf_counter()
                if self._left is not None:
                    self.host_between.append((t0 - self._left) * 1e3)
                start.record()
                state, m = step(state, batch, generator)
                end.record()
                self._left = time.perf_counter()
                self.host_in.append((self._left - t0) * 1e3)
                self.events.append((start, end))
                self.metrics.append((m["loss/total"], m["grad_norm"]))
                if self.after is not None:
                    self.after()
                return state, m
            return watched
        with mock.patch.object(trainer_module, "make_train_step",
                               make_watched):
            yield self
        self._last = None

    def ms_per_step(self, first: int = 1) -> float:
        """Device time from the start of step ``first`` (0-based) to the end
        of the last, per step: the card's work and its waits on the host."""
        torch.cuda.synchronize()
        return (self.events[first][0].elapsed_time(self.events[-1][1])
                / (len(self.events) - first))

    def runs(self) -> list:
        return [(loss.item(), norm.item()) for loss, norm in self.metrics]

    def host_ms(self, first: int = 1) -> dict:
        """Median host wall a step from step ``first`` (0-based) on: in the
        step's call (launches) and between calls (the next batch)."""
        return {"in_step": statistics.median(self.host_in[first:]),
                "between": statistics.median(self.host_between[first - 1:])}


class Counting:
    """An iterator that counts the batches pulled from ``source``."""

    def __init__(self, source):
        self.source, self.pulled = iter(source), 0

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.source)
        self.pulled += 1
        return item


@contextlib.contextmanager
def step_profile(skip: int, active: int):
    """torch.profiler's device activities (kernels, copies) over train
    steps ``skip + 1 .. skip + active`` (its ``step`` is called after each
    train step); yields a dict whose "step" is that callable and whose
    "averages" the window's key_averages. Host ops are not traced: the
    window's cost to the host stays a few µs a launch."""
    from torch.profiler import ProfilerActivity, profile, schedule
    holder = {}
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=skip - 1, warmup=1, active=active,
                                   repeat=1),
                 on_trace_ready=lambda p: holder.update(
                     averages=p.key_averages())) as prof:
        holder["step"] = prof.step
        yield holder
    if "averages" not in holder:
        raise AssertionError("the profiler's window did not close")


def window_counts(averages, steps: int) -> dict:
    """Per step of a profiled window: host-to-device copies by kind and
    their device ms, device-to-host copies, and the kernels' device ms and
    launches."""
    out = collections.Counter(dict.fromkeys(
        ("h2d_pinned", "h2d_pageable", "h2d_ms", "d2h", "kernel_ms",
         "launches"), 0))
    for e in averages:
        if "CUDA" not in str(e.device_type):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        # a user annotation (ProfilerStep#n, the optimizer's step) spans
        # kernels that are rows of their own
        if (getattr(e, "is_user_annotation", False)
                or e.key.startswith(("ProfilerStep", "Optimizer."))):
            continue
        if e.key.startswith("Memcpy HtoD"):
            kind = "pinned" if "Pinned" in e.key else "pageable"
            out[f"h2d_{kind}"] += e.count
            out["h2d_ms"] += ms
        elif e.key.startswith("Memcpy DtoH"):
            out["d2h"] += e.count
        elif not e.key.startswith(("Memcpy", "Memset")):
            out["kernel_ms"] += ms
            out["launches"] += e.count
    return {k: v / steps for k, v in out.items()}


def per_step_launches(launches: dict, steps: int) -> dict:
    return {k: v / steps for k, v in launches.items() if v}


def state_equal(a, b) -> bool:
    """Two state trees (dicts, lists, tensors, numbers) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(state_equal, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def cli_argv(*extra: str) -> list:
    return [*CLI_WIDTH, "--batch-size", str(CLI_BATCH), "--modalities",
            "species", "--steps", str(CLI_STEPS), *extra]


def profiled_train(train, steps: int) -> tuple:
    """``train()`` under a StepWatch and a device-only profiler window over
    its steps 3..``steps``: returns train's result, the watch, and the
    window's counts a step. Step ms (``watch.ms_per_step(2)``) and kernel ms
    come from the same steps of the same run."""
    watch = StepWatch()
    with step_profile(2, steps - 2) as prof:
        watch.after = prof["step"]
        with watch.watching():
            out = train()
    torch.cuda.synchronize()
    return out, watch, window_counts(prof["averages"], steps - 2)


def cli_synthetic(root: Path) -> dict:
    """Phase 20 (a)-(c): cli.train on synthetic data at the A-stack's width
    and batch; the same run through the plain versions; echoing; resuming.
    """
    argv = cli_argv("--log-every", str(CLI_LOG_EVERY),
                    "--checkpoint-dir", str(root / "ckpt"),
                    "--metrics-jsonl", str(root / "metrics.jsonl"))
    args = cli_train.parse_args(argv)
    if k1_per_forward(cli_train.make_config(args).fusion) != K1_PER_FORWARD:
        raise AssertionError("the CLI's fusion stack is not 12 layers deep")
    want = expected_launches(**{k: v * CLI_STEPS
                                for k, v in CLI_PER_STEP.items()})

    # (a) the user's command, counted and profiled; no plain version
    # reachable
    kernels.reset_launch_counts()
    with plain_versions_refused():
        (state, metrics), watch, copies = profiled_train(
            lambda: cli_train.main(argv), CLI_STEPS)
    launches = dict(kernels.launch_counts)
    if launches != want:
        raise AssertionError(f"cli.train launches {launches} != {want}")
    if (len(watch.events) != CLI_STEPS or state.step != CLI_STEPS
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"cli.train: {len(watch.events)} steps, "
                             f"state.step {state.step}, metrics {metrics}")
    step_ms = watch.ms_per_step(2)
    kernel_runs = watch.runs()
    logged = [json.loads(line) for line in
              (root / "metrics.jsonl").read_text().splitlines()]
    if logged[-1]["step"] != CLI_STEPS or not (
            root / "ckpt" / f"step_{CLI_STEPS:08d}.pt").exists():
        raise AssertionError("cli.train wrote no final checkpoint or metrics")
    final = {"model": copy.deepcopy(state.model.state_dict()),
             "optimizer": copy.deepcopy(state.optimizer.state_dict()),
             "step": state.step}
    del state

    if copies["h2d_pinned"] != CLI_PINNED_PER_BATCH:
        raise AssertionError(f"cli.train's copies a step: {copies}")

    # (b) the same steps, seed and batches through the plain versions
    with plain_versions():
        _, plain, _ = profiled_train(
            lambda: cli_train.main(cli_argv("--log-every", "0")), CLI_STEPS)
    plain_runs = plain.runs()
    rel = {k: max(abs(a[i] - b[i]) / abs(b[i])
                  for a, b in zip(kernel_runs, plain_runs))
           for i, k in enumerate(("loss", "grad_norm"))}
    if any(rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"cli.train kernel vs plain: {kernel_runs} vs "
                             f"{plain_runs} (tol {TRAIN_TOL})")

    # (c) echoing: the CLI's model and data through Trainer.fit(echo 2)
    cfg = cli_train.make_config(args)
    cfg.add_modality(cli_train.synthetic_modalities(SyntheticConfig())[
        "species"])
    source = Counting(SyntheticEarthDataGenerator(
        SyntheticConfig()).batch_iterator(CLI_BATCH))
    pulled = []
    with step_profile(2, CLI_STEPS - 2) as echo_prof:
        def after():
            pulled.append(source.pulled)
            echo_prof["step"]()
        echo = StepWatch(after=after)
        with echo.watching():
            model = DeepEarthModel(
                cfg, generator=torch.Generator(device="cuda").manual_seed(
                    SEED), device="cuda")
            trainer = Trainer(model, cfg, LossWeights(contrastive=0.01),
                              seed=SEED)
            trainer.fit(trainer.init_state(), data_device_prefetch(source),
                        CLI_STEPS, log_every=0, echo_factor=2)
    echo_copies = window_counts(echo_prof["averages"], CLI_STEPS - 2)
    echo_pulled = (pulled[-1] - pulled[1]) / (CLI_STEPS - 2)
    if (echo.distinct != CLI_STEPS // 2 or echo_pulled != 0.5
            or echo_copies["h2d_pinned"] != CLI_PINNED_PER_BATCH / 2):
        raise AssertionError(f"echo 2: {echo.distinct} batches consumed, "
                             f"{echo_pulled} pulled a step, copies "
                             f"{echo_copies}")
    del model, trainer

    # resuming: --resume with no further step loads (a)'s state bit for bit
    resumed, _ = cli_train.main(cli_argv(
        "--log-every", "0", "--checkpoint-dir", str(root / "ckpt"),
        "--resume", "--steps", "0"))
    same = (resumed.step == final["step"]
            and state_equal(resumed.model.state_dict(), final["model"])
            and state_equal(resumed.optimizer.state_dict(),
                            final["optimizer"]))
    if not same:
        raise AssertionError("--resume did not load the saved state bit for "
                             "bit")
    del resumed, final
    free_cuda()
    return {"launches": launches, "step_ms": step_ms, "copies": copies,
            "host": watch.host_ms(2),
            "metrics": metrics, "kernel_runs": kernel_runs,
            "plain_runs": plain_runs, "plain_step_ms": plain.ms_per_step(2),
            "rel": rel, "echo_copies": echo_copies,
            "echo_pulled": echo_pulled, "echo_distinct": echo.distinct}


@contextlib.contextmanager
def k3_sites(sites: set):
    """Adds to ``sites`` the (direction, route, dtype, scale, B, H, Nq, Nk,
    Dqk, Dv, key mask, v strided) of every K3 launch made inside: the shapes
    the main path gives K3."""
    fwd, bwd = kernels.vmem_attention_fwd, kernels.vmem_attention_bwd

    def add(direction, q, k, v, scale, key_mask):
        b, h, nq, dqk = q.shape
        sites.add((direction, attention_route(q, k, v), q.dtype,
                   float(scale), b, h, nq, k.shape[2], dqk, v.shape[3],
                   key_mask is not None, not v.is_contiguous()))

    def fwd_seen(q, k, v, scale, key_mask=None):
        add("fwd", q, k, v, scale, key_mask)
        return fwd(q, k, v, scale, key_mask)

    def bwd_seen(q, k, v, dout, scale, key_mask=None):
        add("bwd", q, k, v, scale, key_mask)
        return bwd(q, k, v, dout, scale, key_mask)

    with mock.patch.object(kernels, "vmem_attention_fwd", fwd_seen), \
            mock.patch.object(kernels, "vmem_attention_bwd", bwd_seen):
        yield sites


def check_k3_sites(sites: set) -> dict:
    """K3-fwd and K3-bwd at each of the main path's sites, on inputs drawn
    at those shapes, dtypes and scales (a generator of their own), against
    the plain versions: the output within VMEM_TOL, the gradients within
    BWD_TOL of their largest entries, each case on the route the path took.
    Returns the largest error a direction and the sites checked."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for (direction, route, dtype, scale, b, h, nq, nk, dqk, dv, mask,
         strided) in sorted(sites, key=str):
        name = f"K3-{direction} {b}x{h} {nq}x{nk} Dqk{dqk} Dv{dv} {dtype}"
        q, k, v, do, key_mask = attention_case(
            gen, b, h, nq, nk, dqk, dv, dtype, mask, strided)
        if attention_route(q, k, v) != route:
            raise AssertionError(f"{name}: the case's route differs from the "
                                 f"path's ({route!r})")
        kw = dict(scale=scale, key_mask=key_mask)
        if direction == "fwd":
            err = max_err(kernels.vmem_attention_fwd(q, k, v, **kw),
                          attention_vmem.vmem_attention_plain(q, k, v, **kw))
            if err > VMEM_TOL[dtype]:
                raise AssertionError(f"{name}: max_abs_err {err} > "
                                     f"{VMEM_TOL[dtype]}")
        else:
            err = check_grads(
                name, kernels.vmem_attention_bwd(q, k, v, do, **kw),
                attention_vmem.vmem_attention_bwd_plain(q, k, v, do, **kw),
                dtype, key_mask)
        errs[direction] = max(errs[direction], err)
        del q, k, v, do
    if {site[0] for site in sites} != set(errs):
        raise AssertionError(f"K3 sites of the real-data path: {sites}")
    return {"max_abs_err": errs, "sites": sorted(
        f"{d} B{b} H{h} {nq}x{nk} Dqk{dqk} Dv{dv}{' masked' * mask}"
        f"{' v strided' * strided} route {route or 'TMA'}"
        for d, route, _, _, b, h, nq, nk, dqk, dv, mask, strided in sites)}


def write_real_dataset(root: Path):
    """cli.prepare_data's stores at the published widths over REAL_OBS
    observations: language (7168) through the CLI over a parquet file,
    vision (576 x 1408, fp16) through its conversion from chunks drawn with
    numpy; the observations as an ObservationDataset from arrays."""
    import pandas as pd

    rng = np.random.default_rng(SEED)
    ids = np.arange(1_000_000, 1_000_000 + REAL_OBS)
    lang = rng.standard_normal((REAL_OBS,) + LANGUAGE_STORE_SHAPE,
                               dtype=np.float32)
    pd.DataFrame({"gbif_id": ids, "embedding": list(lang)}).to_parquet(
        root / "language.parquet")
    cli_prepare.main(["--input", str(root / "language.parquet"), "--shape",
                      *map(str, LANGUAGE_STORE_SHAPE), "--output",
                      str(root / "language")])
    n_elem = math.prod(VISION_STORE_SHAPE)
    chunks = ((ids[lo:lo + REAL_BATCH],
               rng.standard_normal((len(ids[lo:lo + REAL_BATCH]), n_elem),
                                   dtype=np.float32))
              for lo in range(0, REAL_OBS, REAL_BATCH))
    cli_prepare.write_store(str(root / "vision"), VISION_STORE_SHAPE,
                            "float16", chunks)
    return ObservationDataset.from_arrays(
        gbif_id=ids,
        species=rng.choice(["Quercus", "Pinus", "Acer", "Sabal", "Serenoa"],
                           REAL_OBS),
        latitude=28.03 + rng.random(REAL_OBS) * 0.95,
        longitude=-81.93 + rng.random(REAL_OBS) * 1.03,
        year=rng.integers(2010, 2026, REAL_OBS),
        month=rng.integers(1, 13, REAL_OBS))


def cli_real_data(root: Path) -> dict:
    """Phase 20 (d): the --data-dir path's body over stores that
    cli.prepare_data wrote, with device_prefetch and with
    device_prefetch_compressed in its place; the native gather against the
    store."""
    t0 = time.perf_counter()
    ds = write_real_dataset(root)
    write_s = time.perf_counter() - t0
    loaders = cli_train.open_stores(str(root))
    args = cli_train.parse_args([
        *CLI_WIDTH, "--batch-size", str(REAL_BATCH), "--steps",
        str(REAL_STEPS), "--log-every", "0", "--data-dir", str(root)])

    sites = set()

    def run(prefetch, versions=plain_versions_refused):
        kernels.reset_launch_counts()
        with versions(), k3_sites(sites), mock.patch.object(
                cli_train, "device_prefetch", prefetch):
            (state, metrics), watch, copies = profiled_train(
                lambda: cli_train.train_on_dataset(
                    args, cli_train.make_config(args), ds, loaders),
                REAL_STEPS)
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"real-data path: {metrics}")
        return {"step_ms": watch.ms_per_step(2), "host": watch.host_ms(2),
                "launches": dict(kernels.launch_counts), "copies": copies,
                "runs": watch.runs(),
                "seq_len": state.model.encoder_vision.position_embedding.shape[
                    -2]}

    # one profiled run a prefetch mode, then the kernel run's steps, seed
    # and batches through the plain versions
    runs = {"plain": run(data_device_prefetch),
            "int8": run(device_prefetch_compressed),
            "versions": run(data_device_prefetch, plain_versions)}
    launches = runs["plain"]["launches"]
    per_step = per_step_launches(launches, REAL_STEPS)
    if (per_step.get("grid4d_encode_fwd") != K2_PER_FORWARD
            or per_step.get("hash_encode_bwd") != K2_BWD_PER_STEP
            or runs["plain"]["seq_len"] != VISION_STORE_SHAPE[0]
            or runs["int8"]["launches"] != launches):
        raise AssertionError(f"real-data path: launches a step {per_step}, "
                             f"int8 {runs['int8']['launches']}, vision "
                             f"positions {runs['plain']['seq_len']}")
    kernel_runs, plain_runs = runs["plain"]["runs"], runs["versions"]["runs"]
    rel = {k: max(abs(a[i] - b[i]) / abs(b[i])
                  for a, b in zip(kernel_runs, plain_runs))
           for i, k in enumerate(("loss", "grad_norm"))}
    if any(rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"real-data path kernel vs plain: {kernel_runs} "
                             f"vs {plain_runs} (tol {TRAIN_TOL})")
    k3 = check_k3_sites(sites)

    # the native gather (csrc/fast_gather.c) against the store's own read
    if not native.native_available():
        raise AssertionError("the native gather did not build")
    vision = loaders["vision"]
    rows = np.arange(0, REAL_OBS, REAL_OBS // REAL_BATCH)
    row_bytes = vision._n_elem * vision.dtype.itemsize
    offsets = vision.offsets[rows] * vision.dtype.itemsize
    gather_ms = {}
    t0 = time.perf_counter()
    got = native.gather_rows(vision._mmap, offsets, row_bytes, n_threads=8)
    gather_ms["native"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want, found = vision.get_batch(vision.ids[rows].tolist(),
                                   out_dtype=np.float16)
    gather_ms["get_batch"] = (time.perf_counter() - t0) * 1e3
    if not found.all() or not np.array_equal(
            got.view(np.float16).reshape(want.shape), want):
        raise AssertionError("the native gather differs from the store's")
    for loader in loaders.values():
        loader.close()
    free_cuda()
    return {"runs": runs, "launches": launches, "per_step": per_step,
            "rel": rel, "k3": k3, "write_s": write_s, "gather_ms": gather_ms,
            "batch_mb": (REAL_BATCH * (math.prod(VISION_STORE_SHAPE)
                                       + math.prod(LANGUAGE_STORE_SHAPE))
                         * 2 / 1e6)}


def cli_serve_request() -> dict:
    """Phase 20 (e): cli.serve with a predictor on the card, on port 0,
    answers one REST predict; it must equal DeepEarth.predict bit for bit
    on a DeepEarth built the same way."""
    earth = DeepEarth()
    earth.register("species", type="categorical", num_classes=232)
    request = ((28.5, -81.4), "2024-06-15", {"species": 7})
    server = cli_serve.start(["--port", "0", "--with-predictor"])
    try:
        client = DashboardClient(f"http://127.0.0.1:{server.port}")
        got, launches = counted(
            lambda: client.predict(*request),
            {"grid4d_encode_fwd": K2_PER_FORWARD,
             k1_fwd_counter(3): k1_per_forward(earth._config.fusion)},
            "cli.serve's predict")
    finally:
        server.stop()
    if not np.array_equal(got, earth.predict(*request)):
        raise AssertionError("cli.serve's answer differs from predict's")
    return {"launches": {k: v for k, v in launches.items() if v},
            "shape": got.shape}


def phase_cli() -> dict:
    """Phase 20: the training entry point and its two siblings."""
    root = CLI_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        syn = cli_synthetic(root)
        real = cli_real_data(root)
        serve = cli_serve_request()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    step, per = syn["step_ms"], per_step_launches(syn["launches"], CLI_STEPS)
    idle = 1 - syn["copies"]["kernel_ms"] / step
    runs = real["runs"]
    # each from one run's profiled window (steps 3..REAL_STEPS)
    share = {k: r["copies"]["h2d_ms"] / r["step_ms"] for k, r in runs.items()}
    real_idle = {k: 1 - r["copies"]["kernel_ms"] / r["step_ms"]
                 for k, r in runs.items()}
    print(f"[20 training entry point] (a) python -m "
          f"deepearth_tpu_torch.cli.train {' '.join(CLI_WIDTH)} --batch-size "
          f"{CLI_BATCH} --modalities species --steps {CLI_STEPS} "
          f"--log-every {CLI_LOG_EVERY} --checkpoint-dir --metrics-jsonl, "
          f"every number from the run's steps 3-{CLI_STEPS} under a "
          f"device-only profiler: {step:.3f} ms a step (CUDA events), "
          f"{CLI_BATCH / step * 1e3:.0f} obs/s; launches a step {per}, no "
          f"plain version reached; host-to-device copies a step: "
          f"{syn['copies']['h2d_pinned']:g} "
          f"pinned, {syn['copies']['h2d_pageable']:g} pageable, "
          f"{syn['copies']['h2d_ms']:.4f} ms; device-to-host "
          f"{syn['copies']['d2h']:g}; kernels "
          f"{syn['copies']['kernel_ms']:.3f} ms in "
          f"{syn['copies']['launches']:.0f} launches a step, device idle "
          f"{idle:.1%}; host ms a step (median): {syn['host']['in_step']:.3f}"
          f" in the step's call, {syn['host']['between']:.3f} between calls "
          f"| (b) plain versions {syn['plain_step_ms']:.3f} ms a "
          f"step (the same window); kernel vs plain over {CLI_STEPS} steps "
          f"(loss, grad_norm): "
          f"kernel {syn['kernel_runs']}, plain {syn['plain_runs']}, rel diff "
          f"{syn['rel']} (tol {TRAIN_TOL}) | (c) echo 2: "
          f"{syn['echo_distinct']} batches over {CLI_STEPS} steps, "
          f"{syn['echo_pulled']:g} pulled and "
          f"{syn['echo_copies']['h2d_pinned']:g} pinned copies a step "
          f"(without echo 1 and {syn['copies']['h2d_pinned']:g}); "
          f"--resume loads step {CLI_STEPS} bit for bit | {card()}")
    plain = runs["plain"]
    print(f"[20 real-data path] (d) cli.prepare_data: {REAL_OBS} "
          f"observations, vision {VISION_STORE_SHAPE} fp16 and language "
          f"{LANGUAGE_STORE_SHAPE} stores in {real['write_s']:.1f} s; "
          f"train_on_dataset (--data-dir's body) at B={REAL_BATCH}, "
          f"{real['batch_mb']:.1f} MB a batch, {REAL_STEPS} steps, one run "
          f"a prefetch mode (times from its steps 3-{REAL_STEPS} under a "
          f"device-only profiler): launches "
          f"a step {real['per_step']}, no plain version reached; the vision "
          f"encoder sized for {plain['seq_len']} patches | "
          f"device_prefetch {plain['step_ms']:.3f} ms a step "
          f"({REAL_BATCH / plain['step_ms'] * 1e3:.0f} obs/s), "
          f"copies a step {plain['copies']['h2d_pinned']:g} pinned "
          f"{plain['copies']['h2d_pageable']:g} pageable in "
          f"{plain['copies']['h2d_ms']:.3f} ms ({share['plain']:.1%} of the "
          f"step, on the copy stream), kernels "
          f"{plain['copies']['kernel_ms']:.3f} ms a step in "
          f"{plain['copies']['launches']:.0f} launches, device idle "
          f"{real_idle['plain']:.1%}; host ms a step (median) "
          f"{plain['host']['in_step']:.3f} in the step's call, "
          f"{plain['host']['between']:.3f} between calls | "
          f"device_prefetch_compressed (int8 on the wire) "
          f"{runs['int8']['step_ms']:.3f} ms a step (host "
          f"{runs['int8']['host']['in_step']:.3f} in, "
          f"{runs['int8']['host']['between']:.3f} between), copies "
          f"{runs['int8']['copies']['h2d_ms']:.3f} ms "
          f"({share['int8']:.1%}), kernels "
          f"{runs['int8']['copies']['kernel_ms']:.3f} ms, device idle "
          f"{real_idle['int8']:.1%} | plain versions "
          f"{runs['versions']['step_ms']:.3f} ms a step; kernel vs plain over "
          f"{REAL_STEPS} steps (loss, grad_norm): kernel {plain['runs']}, "
          f"plain {runs['versions']['runs']}, rel diff {real['rel']} (tol "
          f"{TRAIN_TOL}) | K3 at the path's sites {real['k3']['sites']} "
          f"against the plain versions: max_abs_err fwd "
          f"{real['k3']['max_abs_err']['fwd']:.3g} (tol "
          f"{VMEM_TOL[torch.bfloat16]}), bwd "
          f"{real['k3']['max_abs_err']['bwd']:.3g} (within "
          f"{BWD_TOL[torch.bfloat16]} of each gradient's largest entry) | "
          f"native gather of {REAL_BATCH} vision rows "
          f"{real['gather_ms']['native']:.1f}"
          f" ms (C, 8 threads) vs get_batch {real['gather_ms']['get_batch']:.1f}"
          f" ms, bit for bit | (e) cli.serve --with-predictor on port 0: one "
          f"REST predict {serve['shape']} bit for bit DeepEarth.predict's, "
          f"launches {serve['launches']} | {card()}")
    total = collections.Counter(syn["launches"])
    total.update(real["launches"])
    return {"launches": dict(total), "k3_max_abs_err": real["k3"]["max_abs_err"]}


# --------------------------------------------------------------------------- #
# Phase 21: the token-sequence paths
# --------------------------------------------------------------------------- #

# DeepSeek-V3's config.json (Hugging Face hub, deepseek-ai/DeepSeek-V3): the
# widths of phase 21's classifier, whose depth is cut to the 3 leading dense
# layers (first_k_dense_replace), so that no MoE layer runs
V3_HF_CONFIG = {
    "hidden_size": 7168, "num_attention_heads": 128, "num_hidden_layers": 61,
    "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "n_routed_experts": 256,
    "num_experts_per_tok": 8, "n_shared_experts": 1, "n_group": 8,
    "topk_group": 4, "routed_scaling_factor": 2.5, "norm_topk_prob": True,
    "first_k_dense_replace": 3, "moe_layer_freq": 1, "rms_norm_eps": 1e-6,
    "vocab_size": 129280, "max_position_embeddings": 163840,
    "rope_theta": 10000, "attention_bias": False,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
                     "mscale_all_dim": 1.0}}
CLS_LABELS = 2  # the HF sequence classifiers' default
# forwards: (B, N, where the second row's key mask ends or None); the plain
# path's fp32 scores at B=2, N=4096 (128 heads) would be ~17 GB a tensor,
# several at once. The backward (a cross-entropy on labels) at B=1, N=2048:
# at 4096 the plain autograd would keep ~26 GB of probabilities
CLS_FORWARDS = ((1, 4096, None), (2, 2048, 1500))
CLS_BWD_TOKENS = 2048
CLS_PER_FORWARD = {"flash_attention_fwd": 3}  # one MLA per layer
# the multimodal model of tools/bench_multimodal.py with vision reconstructed
# whole (decode_sequence) and a token-sequence modality: 512 ids of the
# decode bench's 32000-word vocabulary. Per train step K3 runs at the vision
# encoder's MLA and cross-attention (576 keys) and the text encoder's (512
# keys): 4 forwards, 4 backwards; the decoders' attention over 16 / 4
# fused tokens stays on the einsum path, as in JAX
TEXT_TOKENS, TEXT_VOCAB, TEXT_BATCH = 512, 32000, 64
MM_TEXT_PER_STEP = {"vmem_attention_fwd": 4, "vmem_attention_bwd": 4,
                    "grid4d_encode_fwd": K2_PER_FORWARD,
                    "hash_encode_bwd": K2_BWD_PER_STEP}
# the CLIs' checkpoint: DeepSeek-V3's attention shape (q head 192 = nope
# 128 + rope 64, v 128, q-LoRA 1536, kv-LoRA 512, yarn) at a narrow width
# (1024, 8 heads) and 2 layers (a dense one, then 8 routed experts), so that
# the host converts it in seconds; the decode bench's vocabulary
CKPT_HF_CONFIG = {**V3_HF_CONFIG, "hidden_size": 1024,
                  "num_attention_heads": 8, "num_hidden_layers": 2,
                  "intermediate_size": 2816, "moe_intermediate_size": 512,
                  "n_routed_experts": 8, "num_experts_per_tok": 2,
                  "n_group": 1, "topk_group": 1, "first_k_dense_replace": 1,
                  "vocab_size": TEXT_VOCAB}
CKPT_DIR = Path(__file__).resolve().parent / "build" / "ckpt"
CKPT_PROMPT = "live oak savanna near the salt marsh at dawn"
CKPT_NEW_TOKENS = 32


def classifier_config() -> tuple:
    """DeepSeek-V3's block through the converter's config_from_hf, depth cut
    to its dense layers, flash attention on."""
    cfg, vocab = config_from_hf(V3_HF_CONFIG)
    cfg.n_layers = cfg.first_k_dense_replace
    cfg.mla.use_flash_attention = True
    return cfg, vocab


def classifier_params(cfg, vocab: int, labels: int) -> int:
    """The classifier's parameters, reckoned from its config."""
    m, d = cfg.mla, cfg.hidden_dim
    attn = (d * m.q_lora_rank + m.q_lora_rank
            + m.q_lora_rank * m.n_heads * m.q_head_dim
            + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
            + m.kv_lora_rank * m.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            + m.n_heads * m.v_head_dim * d)
    layer = attn + 3 * d * cfg.intermediate_size + 2 * d
    return vocab * d + cfg.n_layers * layer + d + d * labels + labels


def stack_output(model, fn):
    """fn()'s result and the DeepSeek stack's output on the way."""
    seen = []
    hook = model.model.register_forward_hook(
        lambda mod, args, out: seen.append(out.detach()))
    try:
        out = fn()
    finally:
        hook.remove()
    return out, seen[0]


def phase_classifier(gen) -> dict:
    """Phase 21 (b): DeepSeekForSequenceClassification at DeepSeek-V3's
    widths, K4 at 192 / 128 inside it, against the plain path."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, vocab = classifier_config()
    reckoned = classifier_params(cfg, vocab, CLS_LABELS)
    print(f"    21b: {reckoned / 1e9:.3f}B parameters, "
          f"{2 * reckoned / 2 ** 30:.2f} GiB in bf16, before the build")
    model = DeepSeekForSequenceClassification(
        cfg, CLS_LABELS, vocab, generator=gen, device="cuda",
        compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != reckoned:
        raise AssertionError(f"{n_params} parameters, reckoned {reckoned}")
    launches = collections.Counter()
    fwd = {}
    for b, n, last in CLS_FORWARDS:
        ids = torch.randint(0, vocab, (b, n), generator=gen, device="cuda")
        mask = None
        if last is not None:
            mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
            mask[1, last:] = False
        with torch.no_grad():
            (logits, h), got = counted(
                lambda: stack_output(model, lambda: model(ids, mask)),
                CLS_PER_FORWARD, f"classifier B={b} N={n}")
            launches.update(got)
            ms = cuda_ms(lambda: model(ids, mask), iters=3, warmup=1)
            with plain_versions():
                ref_logits, ref_h = stack_output(model,
                                                 lambda: model(ids, mask))
                plain_ms = cuda_ms(lambda: model(ids, mask), iters=1,
                                   warmup=0)
        if not (logits.shape == (b, CLS_LABELS)
                and bool(logits.isfinite().all())):
            raise AssertionError(f"classifier B={b}: logits {logits}")
        diff = (h.float() - ref_h.float()).abs()
        err = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
               "logits_max_abs": max_err(logits, ref_logits)}
        if err["max_abs"] > SLICE_TOL["max_abs"] or \
                err["mean_abs"] > SLICE_TOL["mean_abs"]:
            raise AssertionError(f"classifier B={b} N={n}: stack output vs "
                                 f"plain {err} (tol {SLICE_TOL})")
        fwd[(b, n)] = {**err, "ms": ms, "plain_ms": plain_ms}
        del ids, mask, logits, h, ref_logits, ref_h
        torch.cuda.empty_cache()

    # the backward of a cross-entropy on labels, kernel against plain
    ids = torch.randint(0, vocab, (1, CLS_BWD_TOKENS), generator=gen,
                        device="cuda")
    labels = torch.randint(0, CLS_LABELS, (1,), generator=gen, device="cuda")
    bwd = {}

    def step():
        loss = F.cross_entropy(model(ids).float(), labels)
        loss.backward()
        return loss.detach()
    for label in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        if label == "kernel":
            loss, got = counted(step, {"flash_attention_fwd": 3,
                                       "flash_attention_bwd": 3},
                                "classifier backward")
            launches.update(got)
        else:
            with plain_versions():
                loss = step()
        norm = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(p.grad.float())
            for p in model.parameters()])).item()
        bwd[label] = {"loss": loss.item(), "grad_norm": norm}
        model.zero_grad(set_to_none=True)
        with plain_versions() if label == "plain" else \
                contextlib.nullcontext():
            bwd[label]["step_ms"] = wall_ms(
                lambda: (step(), torch.cuda.synchronize()))
    model.zero_grad(set_to_none=True)
    rel = {k: abs(bwd["kernel"][k] - bwd["plain"][k]) / abs(bwd["plain"][k])
           for k in TRAIN_TOL}
    if any(rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"classifier backward kernel vs plain {bwd} "
                             f"(rel {rel}, tol {TRAIN_TOL})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, ids
    torch.cuda.empty_cache()
    print(f"[21b DeepSeekForSequenceClassification, DeepSeek-V3 widths] "
          f"hidden {cfg.hidden_dim}, {cfg.mla.n_heads} heads (q "
          f"{cfg.mla.q_head_dim} / v {cfg.mla.v_head_dim}), q-LoRA "
          f"{cfg.mla.q_lora_rank}, kv-LoRA {cfg.mla.kv_lora_rank}, dense "
          f"{cfg.intermediate_size}, vocab {vocab}, yarn x"
          f"{cfg.mla.rope_scaling.factor:g}, {cfg.n_layers} dense layers "
          f"(cut from 61: first_k_dense_replace), bf16, {n_params / 1e9:.3f}B"
          f" parameters | per forward K4-fwd 3 (TMA route), no plain version "
          "reached | stack output vs plain path: " + "; ".join(
              f"B={b} N={n}{' masked' if last else ''} max_abs "
              f"{fwd[(b, n)]['max_abs']:.4g} mean_abs "
              f"{fwd[(b, n)]['mean_abs']:.4g} (logits "
              f"{fwd[(b, n)]['logits_max_abs']:.4g}), ms {fwd[(b, n)]['ms']:.2f}"
              f" (plain {fwd[(b, n)]['plain_ms']:.2f})"
              for b, n, last in CLS_FORWARDS)
          + f" (tol {SLICE_TOL}) | backward of a cross-entropy at B=1 N="
          f"{CLS_BWD_TOKENS}: K4-fwd 3, K4-bwd 3; loss / grad norm kernel "
          f"{bwd['kernel']['loss']:.5f} / {bwd['kernel']['grad_norm']:.5g}, "
          f"plain {bwd['plain']['loss']:.5f} / {bwd['plain']['grad_norm']:.5g}"
          f", rel {rel} (tol {TRAIN_TOL}); step ms kernel "
          f"{bwd['kernel']['step_ms']:.1f}, plain {bwd['plain']['step_ms']:.1f}"
          f" (host wall, synchronised) | peak mem {peak:.1f} GiB | {card()}")
    return {"launches": dict(launches), "fwd": fwd, "bwd": bwd, "rel": rel}


def text_mm_config() -> DeepEarthConfig:
    cfg = multimodal_config()
    cfg.modalities["vision"].decode_sequence = True
    cfg.add_modality(ModalityConfig(
        name="text", encoding_type="token_sequence", input_type="text",
        vocab_size=TEXT_VOCAB, n_tokens=4, encoder_layers=1,
        encoder_heads=8))
    return cfg


def make_text_batch(gen, n):
    batch = make_mm_batch(gen, n)
    batch["modalities"]["text"] = torch.randint(
        0, TEXT_VOCAB, (n, TEXT_TOKENS), generator=gen, device="cuda")
    return batch


def phase_text_train(gen) -> dict:
    """Phase 21 (c): the multimodal train step with token sequences (MLM)
    and a whole-sequence vision decoder (MAE)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = text_mm_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda",
                           native_seq_lens={"vision": VISION_PATCHES,
                                            "text": TEXT_TOKENS})
    trainer = Trainer(model, cfg, MM_LOSS_WEIGHTS, seed=SEED)
    state = trainer.init_state()
    start = copy.deepcopy(model.state_dict())
    batches = [make_text_batch(gen, TEXT_BATCH) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, metrics), launches = counted(
        lambda: trainer.fit(state, iter(batches), TRAIN_STEPS,
                            log_every=TRAIN_STEPS),
        {k: v * TRAIN_STEPS for k, v in MM_TEXT_PER_STEP.items()},
        "text train steps")
    fit_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    for key in ("loss/text", "acc/text", "loss/vision"):
        if not math.isfinite(metrics.get(key, math.nan)):
            raise AssertionError(f"{key} = {metrics.get(key)}")
    cmp = train_kernel_vs_plain(trainer, model, start, batches)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    step_ms = cuda_ms(lambda: trainer.train_step(state, batches[0], g),
                      iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, trainer, state, batches
    torch.cuda.empty_cache()
    print(f"[21c train slice with token sequences] tools/bench_multimodal.py"
          f"'s model, vision decode_sequence over {VISION_PATCHES} patches, "
          f"text token_sequence over {TEXT_TOKENS} ids (vocab {TEXT_VOCAB}), "
          f"B={TEXT_BATCH}, the config's MLM and MAE masks, contrastive 0.1: "
          f"launches per step {MM_TEXT_PER_STEP} (routes over the run: "
          + route_counts(launches, "vmem_attention_fwd", "vmem_attention_bwd")
          + "), no plain version reached | fit loss "
          f"{metrics['loss/total']:.4f} (text {metrics['loss/text']:.4f}, "
          f"vision {metrics['loss/vision']:.4f}) | kernel vs plain path over "
          f"{TRAIN_STEPS} steps (loss, grad_norm): kernel "
          f"{cmp['runs']['kernel']}, plain {cmp['runs']['plain']}, rel diff "
          f"{cmp['rel']} (tol {TRAIN_TOL}), params max_abs "
          f"{cmp['param_err']:.3g} (tol {cmp['param_tol']:.3g}) | "
          f"{step_ms:.1f} ms a step after warm-up (CUDA events over 3 "
          f"steps; {TEXT_BATCH / step_ms * 1e3:.0f} obs/s), {fit_ms:.1f} over "
          f"the counted fit's first steps (host wall) | peak mem "
          f"{peak:.1f} GiB | {card()}")
    return {"launches": launches, "cmp": cmp, "step_ms": step_ms}


def write_safetensors_file(path: Path, tensors: dict) -> None:
    """A .safetensors file written here, not by the port's writer: an
    8-byte little-endian header length, the JSON header, the raw bytes."""
    header, at, blobs = {}, 0, []
    names = {torch.float32: "F32", torch.bfloat16: "BF16"}
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def hf_checkpoint(gen, c: dict) -> dict:
    """An HF DeepseekV3ForCausalLM state dict for config ``c``: bf16, drawn
    on the card from ``gen``, returned on the host."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qh = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    shapes = {"model.embed_tokens.weight": (c["vocab_size"], d),
              "model.norm.weight": (d,),
              "lm_head.weight": (c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        shapes.update({
            f"{p}.input_layernorm.weight": (d,),
            f"{p}.post_attention_layernorm.weight": (d,),
            f"{p}.self_attn.q_a_proj.weight": (c["q_lora_rank"], d),
            f"{p}.self_attn.q_a_layernorm.weight": (c["q_lora_rank"],),
            f"{p}.self_attn.q_b_proj.weight": (h * qh, c["q_lora_rank"]),
            f"{p}.self_attn.kv_a_proj_with_mqa.weight": (
                c["kv_lora_rank"] + c["qk_rope_head_dim"], d),
            f"{p}.self_attn.kv_a_layernorm.weight": (c["kv_lora_rank"],),
            f"{p}.self_attn.kv_b_proj.weight": (
                h * (c["qk_nope_head_dim"] + c["v_head_dim"]),
                c["kv_lora_rank"]),
            f"{p}.self_attn.o_proj.weight": (d, h * c["v_head_dim"])})
        if i < c["first_k_dense_replace"]:
            mlps = {f"{p}.mlp": c["intermediate_size"]}
        else:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            shapes[f"{p}.mlp.gate.weight"] = (e, d)
            shapes[f"{p}.mlp.gate.e_score_correction_bias"] = (e,)
            mlps = {f"{p}.mlp.experts.{j}": f for j in range(e)}
            mlps[f"{p}.mlp.shared_experts"] = f * c["n_shared_experts"]
        for m, f in mlps.items():
            shapes.update({f"{m}.gate_proj.weight": (f, d),
                           f"{m}.up_proj.weight": (f, d),
                           f"{m}.down_proj.weight": (d, f)})
    out = {}
    for name, shape in shapes.items():
        std = 1.0 / math.sqrt(shape[-1]) if len(shape) == 2 else 0.02
        t = torch.randn(shape, generator=gen, device="cuda") * std
        if name.endswith("norm.weight"):
            t = t + 1.0
        out[name] = t.to(torch.bfloat16).cpu()
    return out


def phase_checkpoint_cli(gen) -> dict:
    """Phase 21 (d): cli.convert_checkpoint --verify and cli.generate on the
    card, the tokens against an in-process generate on the same params."""
    root = CKPT_DIR
    shutil.rmtree(root, ignore_errors=True)
    (root / "hf").mkdir(parents=True)
    try:
        sd = hf_checkpoint(gen, CKPT_HF_CONFIG)
        write_safetensors_file(root / "hf" / "model.safetensors", sd)
        (root / "hf" / "config.json").write_text(json.dumps(CKPT_HF_CONFIG))
        n_hf = sum(t.numel() for t in sd.values())
        del sd
        out = root / "converted"
        t0 = time.perf_counter()
        (_, cfg, vocab), convert_launches = counted(
            lambda: cli_convert.main([str(root / "hf"), str(out),
                                      "--verify"]), {}, "convert --verify")
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, gen_launches = counted(lambda: cli_generate.main(
            [str(out), "--prompt", CKPT_PROMPT, "--max-new-tokens",
             str(CKPT_NEW_TOKENS)]), {}, "generate")
        generate_s = time.perf_counter() - t0
        # in process, on the same directory's parameters
        params = read_msgpack_tree(out / "params.msgpack")
        model = DeepSeekForCausalLM(
            cfg, vocab, generator=torch.Generator(device="cuda"),
            device="cuda", tie_embeddings=False)
        load_flax_params(model, params)
        ids = [t % vocab for t in HashEmbedder().tokenize(CKPT_PROMPT)]
        with torch.no_grad():
            ref = generate(model.eval(), torch.tensor([ids], device="cuda"),
                           CKPT_NEW_TOKENS)[0].tolist()
        if toks != ref or len(toks) != CKPT_NEW_TOKENS:
            raise AssertionError(f"cli.generate {toks} != in-process {ref}")
        msgpack_mb = (out / "params.msgpack").stat().st_size / 1e6
        del model, params
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[21d checkpoint CLIs] an HF DeepSeek-V3-shaped checkpoint (hidden "
          f"{cfg.hidden_dim}, {cfg.mla.n_heads} heads of q "
          f"{cfg.mla.q_head_dim} / v {cfg.mla.v_head_dim}, kv-LoRA "
          f"{cfg.mla.kv_lora_rank}, {cfg.n_layers} layers, the second with "
          f"{cfg.moe.n_routed_experts} experts; {n_hf / 1e6:.1f}M bf16 "
          f"parameters) written as .safetensors here; cli.convert_checkpoint "
          f"--verify {convert_s:.1f} s (params.msgpack {msgpack_mb:.1f} MB, "
          f"fp32), cli.generate {CKPT_NEW_TOKENS} greedy tokens "
          f"{generate_s:.1f} s (host wall, build of the model included), fp32"
          f" on the card: no hand-written kernel on these paths (launches "
          f"{sum(convert_launches.values())} + "
          f"{sum(gen_launches.values())}) | tokens equal an in-process "
          f"generate on the same parameters: {toks} | {card()}")
    return {"tokens": toks}


def phase_tokens(gen) -> dict:
    """Phase 21: the token-sequence paths."""
    t0 = time.perf_counter()
    wide = phase_wide_flash(gen)
    cls = phase_classifier(gen)
    text = phase_text_train(gen)
    ckpt = phase_checkpoint_cli(gen)
    print(f"[21 token sequences] wall {time.perf_counter() - t0:.1f} s")
    return {"wide": wide, "classifier": cls, "text": text, "ckpt": ckpt}


# --------------------------------------------------------------------------- #
# phase 22: activation checkpointing, the A-stack blocks, the fusion
# pyramid, the C-stack and the inductive simulator
# --------------------------------------------------------------------------- #

# (a) the flagship's train step of phase 16 (576 patches, B=64, bf16 first
# moment, factored second moment, moe_aux 0.01) with remat off, then with
# every modality's encoder_remat and fusion.remat (the fusion layers and the
# simulator's blocks) under each policy; TRAIN_STEPS steps each, every run's
# model built from one seed and trained on the same batches
REMAT_RUNS = (None, "full", "dots")
# the kernels a flagship step launches in the forward inside a checkpointed
# block (the simulator's K5-fwd, the vision encoder's K3-fwd): the
# recompute launches them again
REMAT_FWD_KERNELS = ("grouped_matmul_fwd", "vmem_attention_fwd")
# (b) the C-stack at its published widths (V-JEPA2 1408 per patch, an image
# of 576 patches or a clip of 8 x 24 x 24 for the full-grid decoder, a
# 7168-wide language embedding) and each module's default widths, bf16
# compute over fp32 parameters; the optimizer's cosine schedule without
# warmup (lr 1e-4 at the first step). The full-grid decoder's batch is
# bounded by memory, not time: 3 steps at B=192 took ~0.4 s and 45.2 GiB
# on an H100 (PERF.md), so B=256 reaches ~60 GiB
CSTACK_BIDIR_BATCH, CSTACK_AE_BATCH, CSTACK_SHARED_BATCH = 256, 512, 64
CSTACK_UNET_BATCH, N_SPECIES, CSTACK_STEPS = 512, 232, 3
CSTACK_OPT = OptimizerConfig(warmup_steps=0)
# (c) the A-stack blocks at the A-stack's width (768, 12 heads): the
# modality encoder (its transformer 4 layers deep, as the A-stack's) at
# B=4096, a 4-layer transformer over 576 tokens with interleaved RoPE (K3 at
# 576 keys, 64-wide heads); a 3-level pyramid over the multimodal config's
# fusion (512 wide, 4 layers) with 16 vision and 4 language tokens
ASTACK_ENC_BATCH, ASTACK_TF_BATCH, ASTACK_LAYERS = 4096, 64, 4
HIER_BATCH, HIER_LEVELS = 512, 3
# (d) the inductive simulator's standard preset (24 layers, 2048 wide, 16
# heads, 8 experts), bf16, its MLA's flash gate on (the preset leaves it
# off, and JAX then takes its plain path at 192-wide heads), at B=8 over
# 1024 tokens with 15% of them masked
SIM_BATCH, SIM_TOKENS, SIM_MASK_RATIO = 8, 1024, 0.15


def set_remat_config(cfg: DeepEarthConfig, policy: Optional[str]) -> None:
    """Every modality's encoder_remat and fusion.remat on under ``policy``
    (None: off)."""
    on, name = policy is not None, policy or "full"
    cfg.fusion.remat, cfg.fusion.remat_policy = on, name
    for m in cfg.modalities.values():
        m.encoder_remat, m.encoder_remat_policy = on, name


def step_loads(model) -> list:
    """Each MoE site's routed-token counts of its last call, in order."""
    return [m.load.clone() for m in moe_sites(model).values()]


def read_peak_before_update(state) -> list:
    """Make ``state``'s optimizer read the peak memory (GiB) as each update
    starts, into the returned list: the peak of the forward and backward
    alone when the peak is reset as each step starts."""
    update, readings = state.optimizer.step, []

    def step():
        readings.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        update()
    state.optimizer.step = step
    return readings


def step_peaks(trainer, batch) -> dict:
    """One train step of ``trainer`` from a fresh state: the peak memory of
    its forward and backward and of the whole step, in GiB."""
    st = trainer.init_state()
    readings = read_peak_before_update(st)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(st, batch, torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    peaks = {"fwd_bwd_gib": readings[0],
             "step_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del st
    trainer.model.zero_grad(set_to_none=True)
    return peaks


def remat_train_run(policy: Optional[str]) -> dict:
    """TRAIN_STEPS flagship train steps with remat at ``policy``: the model
    built from flagship_generator() (the same weights every run), the
    batches and the trainer's masks from seeded generators of their own."""
    free_cuda()
    cfg = flagship_train_config()
    set_remat_config(cfg, policy)
    model = DeepEarthModel(cfg, generator=flagship_generator(),
                           device="cuda",
                           native_seq_lens={"vision": VISION_PATCHES,
                                            "language": 16})
    stacks = [m for m in model.modules()
              if isinstance(m, (fusion.CrossModalFusion, DeepSeekTransformer))]
    if any(m.remat != (policy is not None) for m in stacks):
        raise AssertionError(f"remat {policy}: a stack built otherwise")
    weights_sum = sum(p.float().sum().item() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [make_flagship_batch(gen, FLAGSHIP_TRAIN_BATCH, VISION_PATCHES)
               for _ in range(TRAIN_STEPS)]
    trainer = Trainer(model, cfg, FLAGSHIP_TRAIN_WEIGHTS, seed=SEED)
    st = trainer.init_state()
    before_update = read_peak_before_update(st)
    steps, peak = [], 0.0
    with plain_versions_refused():
        for batch in batches:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            st, m = trainer.train_step(st, batch, trainer.generator)
            end.record()
            end.synchronize()
            steps.append({
                "ms": start.elapsed_time(end),
                "metrics": tuple(m[k].item() for k in
                                 ("loss/total", "loss/moe_aux", "grad_norm")),
                "launches": {k: v for k, v in kernels.launch_counts.items()
                             if v},
                "modes": site_modes(model), "loads": step_loads(model)})
            peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    del st, trainer, model, batches
    free_cuda()
    return {"steps": steps, "peak_gib": peak, "weights_sum": weights_sum,
            "fwd_bwd_peak_gib": max(before_update)}


def phase_remat_train() -> dict:
    runs = {policy: remat_train_run(policy) for policy in REMAT_RUNS}
    off = runs[None]
    want = {k: v for k, v in expected_launches(**FLAGSHIP_PER_STEP).items()
            if v}
    for s in off["steps"]:
        if s["launches"] != want:
            raise AssertionError(f"remat off: launches a step "
                                 f"{s['launches']} != {want}")
    rel, added = {}, {}
    for policy in REMAT_RUNS[1:]:
        run = runs[policy]
        if run["weights_sum"] != off["weights_sum"]:
            raise AssertionError(f"remat {policy}: other weights")
        rel[policy] = train_rel([s["metrics"] for s in run["steps"]],
                                [s["metrics"] for s in off["steps"]])
        for s, s0 in zip(run["steps"], off["steps"]):
            if s["modes"] != s0["modes"] or not all(
                    torch.equal(a, b) for a, b in zip(s["loads"],
                                                      s0["loads"])):
                raise AssertionError(f"remat {policy}: dispatch modes or "
                                     "routed-token counts differ from remat "
                                     "off")
            for name in set(s["launches"]) | set(s0["launches"]):
                n, n0 = s["launches"].get(name, 0), s0["launches"].get(name, 0)
                if name in REMAT_FWD_KERNELS:
                    if n <= n0:
                        raise AssertionError(
                            f"remat {policy}: {name} {n} a step, no more "
                            f"than without remat ({n0})")
                elif n != n0:
                    raise AssertionError(f"remat {policy}: {name} {n} a step"
                                         f" != {n0} without remat")
        added[policy] = {k: run["steps"][-1]["launches"][k]
                         - off["steps"][-1]["launches"][k]
                         for k in REMAT_FWD_KERNELS}

    def line(policy):
        run = runs[policy]
        ms = [s["ms"] for s in run["steps"]]
        launches = run["steps"][-1]["launches"]
        return (f"{policy or 'off'}: step ms (CUDA events) "
                + ", ".join(f"{x:.1f}" for x in ms)
                + f" (steps 2-{TRAIN_STEPS} mean "
                f"{statistics.mean(ms[1:]):.1f}), peak {run['peak_gib']:.2f}"
                f" GiB a step, {run['fwd_bwd_peak_gib']:.2f} GiB in its "
                f"forward and backward (before the update), a step launches "
                f"K5-fwd "
                f"{launches.get('grouped_matmul_fwd', 0)}, K5-bwd "
                f"{launches.get('grouped_matmul_bwd_dlhs', 0)} / "
                f"{launches.get('grouped_matmul_bwd_drhs', 0)}, K3 "
                f"{launches.get('vmem_attention_fwd', 0)} / "
                f"{launches.get('vmem_attention_bwd', 0)}, K4 "
                f"{launches.get('flash_attention_fwd', 0)} / "
                f"{launches.get('flash_attention_bwd', 0)}; (loss, moe_aux, "
                f"grad norm) by step {[s['metrics'] for s in run['steps']]}")
    print(f"[22a remat, flagship train step] B={FLAGSHIP_TRAIN_BATCH}, "
          f"{VISION_PATCHES} patches, bf16, {FLAGSHIP_TRAIN_WEIGHTS}, every "
          "modality's encoder_remat and fusion.remat (the fusion layers and "
          "the simulator's blocks) | " + " | ".join(line(p) for p in
                                                   REMAT_RUNS)
          + " | against remat off, rel diff: " + "; ".join(
              f"{p} " + ", ".join(f"{k} {v:.3g}" for k, v in r.items())
              for p, r in rel.items())
          + f" (tol {FLAGSHIP_TRAIN_TOL}); dispatch modes and routed tokens "
          "equal at every site and step; launches the recompute adds a step "
          + "; ".join(f"{p} {a}" for p, a in added.items())
          + ", every other kernel as without remat | " + card())
    for policy, r in rel.items():
        if any(r[k] > FLAGSHIP_TRAIN_TOL[k] for k in FLAGSHIP_TRAIN_TOL):
            raise AssertionError(f"remat {policy} against remat off: {r} "
                                 f"(tol {FLAGSHIP_TRAIN_TOL})")
    total = collections.Counter()
    for run in runs.values():
        for s in run["steps"]:
            total.update(s["launches"])
    return {"launches": dict(total),
            "peak_gib": {p or "off": runs[p]["peak_gib"] for p in runs},
            "fwd_bwd_peak_gib": {p or "off": runs[p]["fwd_bwd_peak_gib"]
                                 for p in runs}}


def timed_steps(step, state, batch, gen, n=CSTACK_STEPS):
    """``n`` recipe steps on one batch: per step (loss, ms by CUDA
    events)."""
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch, gen)
        end.record()
        end.synchronize()
        out.append((m["loss/total"].item(), start.elapsed_time(end)))
    return out


def check_falls(name, steps) -> None:
    losses = [loss for loss, _ in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{name}: losses {losses} not finite or not "
                             "falling on one repeated batch")


def grad_norm_of(module) -> float:
    return torch.linalg.vector_norm(torch.stack([
        p.grad.float().norm() for p in module.parameters()
        if p.grad is not None])).item()


def backward_run(module, forward, loss_of, plain: bool) -> tuple:
    """forward() and the backward of loss_of(its output), through the
    kernels (every plain version made to raise) or through the plain
    versions: (the output, the loss, the module's gradient norm)."""
    module.zero_grad(set_to_none=True)
    with (plain_versions() if plain else plain_versions_refused()):
        out = forward()
        loss = loss_of(out)
        loss.backward()
    return out, loss.item(), grad_norm_of(module)


def loss_grad_rel(kernel: tuple, plain: tuple) -> dict:
    """Relative loss and grad-norm differences of two backward_run
    results."""
    return {key: abs(kernel[i] - plain[i]) / abs(plain[i])
            for i, key in ((1, "loss"), (2, "grad_norm"))}


def phase_cstack(gen) -> dict:
    """(b): the C-stack's modules and recipes at their published widths."""
    bf = torch.bfloat16
    init = Init(gen, "cuda")
    res, launches = {}, collections.Counter()

    # the bidirectional reconstructor decoding the full V-JEPA2 grid
    model = BidirectionalReconstructor(full_vision_output=True, init=init,
                                       compute_dtype=bf)
    b = CSTACK_BIDIR_BATCH
    batch = {"vision": torch.randn((b, 4608, 1408), generator=gen,
                                   device="cuda").to(bf),
             "language": torch.randn((b, 7168), generator=gen,
                                     device="cuda").to(bf)}
    with torch.no_grad():
        out = model.eval()(**batch)["vision_from_language"]
    if tuple(out.shape) != (b, 8, 24, 24, 1408) or not bool(
            out.isfinite().all()):
        raise AssertionError(f"full-grid decode {tuple(out.shape)}")
    del out
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res["bidirectional"] = timed_steps(
        make_bidirectional_step(model),
        TrainState(model, create_optimizer(model.parameters(), CSTACK_OPT)),
        batch, gen)
    res["bidirectional_peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    launches.update(kernels.launch_counts)
    check_falls("bidirectional", res["bidirectional"])
    del model, batch
    free_cuda()

    # the fusion-bottleneck autoencoder with its 232-species classifier
    model = MultimodalAutoencoder(n_species=N_SPECIES, init=init,
                                  compute_dtype=bf)
    b = CSTACK_AE_BATCH
    batch = {"vision": torch.randn((b, VISION_PATCHES, 1408), generator=gen,
                                   device="cuda").to(bf),
             "language": torch.randn((b, 7168), generator=gen,
                                     device="cuda").to(bf),
             "species": torch.randint(0, N_SPECIES, (b,), generator=gen,
                                      device="cuda")}
    kernels.reset_launch_counts()
    res["autoencoder"] = timed_steps(
        make_autoencoder_step(model),
        TrainState(model, create_optimizer(model.parameters(), CSTACK_OPT)),
        batch, gen)
    launches.update(kernels.launch_counts)
    check_falls("autoencoder", res["autoencoder"])
    del model, batch
    free_cuda()

    # the shared latent space: 32 latents cross-attend into 577 tokens (K3)
    model = MultimodalSharedSpace({"vision": 1408, "language": 7168},
                                  init=init, compute_dtype=bf)
    b = CSTACK_SHARED_BATCH
    feats = {"vision": torch.randn((b, VISION_PATCHES, 1408), generator=gen,
                                   device="cuda").to(bf),
             "language": torch.randn((b, 7168), generator=gen,
                                     device="cuda").to(bf)}
    targets = {"vision": feats["vision"].float().mean(dim=1),
               "language": feats["language"].float()}

    def shared_step(plain):
        return backward_run(
            model, lambda: model(feats),
            lambda out: sum(((out["reconstructions"][k].float() - t) ** 2)
                            .mean() for k, t in targets.items()), plain)
    kernels.reset_launch_counts()
    with torch.no_grad(), plain_versions_refused():
        out_k = model(feats)
    fwd_launches = dict(kernels.launch_counts)
    with torch.no_grad(), plain_versions():
        out_p = model(feats)
    diff = output_diff(
        {"fused_representation": out_k["shared_embedding"],
         "reconstructions": {**out_k["reconstructions"],
                             "latents": out_k["latents"]}},
        {"fused_representation": out_p["shared_embedding"],
         "reconstructions": {**out_p["reconstructions"],
                             "latents": out_p["latents"]}})
    kernels.reset_launch_counts()
    run_k = shared_step(False)
    step_launches = dict(kernels.launch_counts)
    run_p = shared_step(True)
    shared_ms = cuda_ms(lambda: shared_step(False), iters=5, warmup=1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(feats), iters=10, warmup=2)
    launches.update(fwd_launches)
    launches.update(step_launches)
    res["shared"] = {"diff": diff, "ms": shared_ms,
                     "fwd_ms": fwd_ms, "fwd_launches": fwd_launches,
                     "step_launches": step_launches}
    want_fwd = {"vmem_attention_fwd": 2}
    if {k: v for k, v in fwd_launches.items() if v} != want_fwd:
        raise AssertionError(f"shared space forward launches "
                             f"{fwd_launches} != {want_fwd}")
    if step_launches["vmem_attention_bwd"] != 2:
        raise AssertionError(f"shared space step launches {step_launches}")
    if any(diff[k] > SLICE_TOL[k] for k in SLICE_TOL):
        raise AssertionError(f"shared space kernel vs plain {diff}")
    shared_rel = res["shared"]["rel"] = loss_grad_rel(run_k, run_p)
    if any(shared_rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"shared space kernel vs plain {shared_rel}")
    del model, feats, targets, out_k, out_p, run_k, run_p
    free_cuda()

    # the MLP U-Nets: cross-modal (30% of the language features hidden) and
    # image <-> species over a learned 232-row table, then top-5 retrieval
    b = CSTACK_UNET_BATCH
    unet = MultimodalUNet(1408, 7168, init=init, compute_dtype=bf)
    vision = torch.randn((b, VISION_PATCHES, 1408), generator=gen,
                         device="cuda").to(bf)
    language = torch.randn((b, 7168), generator=gen, device="cuda").to(bf)
    target = torch.cat([vision.float().mean(dim=1), language.float()], -1)

    def unet_step(state, batch, g):
        unet.train()
        unet.zero_grad(set_to_none=True)
        out = unet(vision, language, g)
        recon = torch.cat([out["vision_recon"], out["language_recon"]], -1)
        loss = ((recon.float() - target) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        return state, {"loss/total": loss.detach()}
    res["unet"] = timed_steps(unet_step, TrainState(unet, create_optimizer(
        unet.parameters(), CSTACK_OPT)), None, gen)
    check_falls("multimodal U-Net", res["unet"])
    del unet, vision, language, target

    bimodal = BimodalMLPUNet(N_SPECIES, init=init, compute_dtype=bf)
    emb = torch.randn((b, 2048), generator=gen, device="cuda")

    def bimodal_step(state, batch, g):
        bimodal.train()
        bimodal.zero_grad(set_to_none=True)
        out = bimodal(embedding=emb, generator=g)
        loss = ((out["recon"].float() - out["target"].float()) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        return state, {"loss/total": loss.detach()}
    res["bimodal"] = timed_steps(bimodal_step, TrainState(
        bimodal, create_optimizer(bimodal.parameters(), CSTACK_OPT)), None,
        gen)
    check_falls("bimodal U-Net", res["bimodal"])
    bimodal.eval()
    with torch.no_grad():
        recon = bimodal(embedding=emb)["recon"]
        top = species_topk(recon.float(), bimodal.table().float(), k=5)
        res["topk_ms"] = cuda_ms(lambda: species_topk(
            recon.float(), bimodal.table().float(), k=5), iters=20)
    if tuple(top.shape) != (b, 5) or top.dtype != torch.int32 or not bool(
            ((top >= 0) & (top < N_SPECIES)).all()):
        raise AssertionError(f"species_topk {tuple(top.shape)} {top.dtype}")
    del bimodal, emb, recon, top
    free_cuda()
    res["launches"] = dict(launches)
    return res


def pyramid_inputs(gen, b, d):
    """A 3-level pyramid's inputs: spacetime and species tokens, 16 vision
    tokens on a 4 x 4 grid, 4 language tokens, each with its time."""
    tokens = {"spacetime": 1, "species": 1, "vision": 16, "language": 4}
    toks = {n: torch.randn((b, k, d), generator=gen, device="cuda").to(
        torch.bfloat16) for n, k in tokens.items()}
    g = (torch.arange(4, device="cuda", dtype=torch.float32) + 0.5) / 4
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    spatial = {"vision": grid[None].expand(b, 16, 2)}
    t = torch.rand((b, 1, 1), generator=gen, device="cuda")
    temporal = {n: t.expand(b, k, 1) for n, k in tokens.items()}
    return toks, spatial, temporal


def phase_astack_blocks(gen) -> dict:
    """(c): the A-stack's modality encoder and transformer at 768 / 12,
    and HierarchicalFusion over the multimodal config's fusion."""
    bf = torch.bfloat16
    init = Init(gen, "cuda")
    res, launches = {}, collections.Counter()
    tcfg = TransformerConfig(hidden_dim=768, n_heads=12,
                             n_layers=ASTACK_LAYERS,
                             rope_variant="interleaved")

    # the modality encoder: one token per observation, plain attention
    enc = ModalityEncoder(1408, 768, tcfg, init, bf).eval()
    x = torch.randn((ASTACK_ENC_BATCH, 1408), generator=gen, device="cuda")
    mask = torch.rand((ASTACK_ENC_BATCH,), generator=gen, device="cuda") > 0.2
    kernels.reset_launch_counts()
    with torch.inference_mode(), plain_versions_refused():
        out = enc(x, mask)
        res["encoder_ms"] = cuda_ms(lambda: enc(x, mask), iters=10)
    if tuple(out.shape) != (ASTACK_ENC_BATCH, 768) or not bool(
            out.isfinite().all()) or any(kernels.launch_counts.values()):
        raise AssertionError("modality encoder: shape, values or launches")
    del enc, x, mask, out

    # the transformer over 576 tokens: K3 in every layer
    tf = Transformer(tcfg, init, bf)
    x = torch.randn((ASTACK_TF_BATCH, VISION_PATCHES, 768), generator=gen,
                    device="cuda").to(bf)

    def tf_run(plain):
        return backward_run(tf, lambda: tf(x),
                            lambda out: out.float().square().mean(), plain)
    kernels.reset_launch_counts()
    run_k = tf_run(False)
    tf_launches = dict(kernels.launch_counts)
    run_p = tf_run(True)
    res["transformer"] = {
        "diff": output_diff({"fused_representation": run_k[0],
                             "reconstructions": {}},
                            {"fused_representation": run_p[0],
                             "reconstructions": {}}),
        "rel": loss_grad_rel(run_k, run_p),
        "ms": cuda_ms(lambda: tf_run(False), iters=3, warmup=1),
        "plain_ms": cuda_ms(lambda: tf_run(True), iters=3, warmup=1),
        "launches": {k: v for k, v in tf_launches.items() if v},
        "all_launches": tf_launches}
    want = {"vmem_attention_fwd": ASTACK_LAYERS,
            "vmem_attention_bwd": ASTACK_LAYERS}
    if res["transformer"]["launches"] != want:
        raise AssertionError(f"transformer launches {tf_launches} != {want}")
    launches.update(tf_launches)
    del tf, x, run_k, run_p
    free_cuda()

    # the fusion pyramid: 23, 13 and 8 tokens; the last level token-major
    fcfg = multimodal_config().fusion
    names = ["spacetime", "species", "vision", "language"]
    pyr = HierarchicalFusion(fcfg, names, init, bf, num_levels=HIER_LEVELS,
                             spatial=True)
    toks, spatial, temporal = pyramid_inputs(gen, HIER_BATCH,
                                             fcfg.universal_dim)
    per_level = {}

    def level_hooks():
        hooks = []
        for lv in range(HIER_LEVELS):
            mod = getattr(pyr, f"level_{lv}")
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, lv=lv: per_level.__setitem__(
                    lv, dict(kernels.launch_counts))))
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, lv=lv: per_level.__setitem__(lv, {
                    k: kernels.launch_counts[k] - per_level[lv][k]
                    for k in per_level[lv]
                    if kernels.launch_counts[k] - per_level[lv][k]})))
        return hooks

    def pyr_run(plain):
        return backward_run(
            pyr, lambda: pyr(toks, spatial, temporal),
            lambda out: out["fused_representation"].float().square().mean(),
            plain)
    hooks = level_hooks()
    kernels.reset_launch_counts()
    run_k = pyr_run(False)
    for h in hooks:
        h.remove()
    pyr_launches = dict(kernels.launch_counts)
    run_p = pyr_run(True)
    diff = output_diff(*[
        {"fused_representation": out["fused_representation"],
         "reconstructions": dict(enumerate(out["level_representations"]))}
        for out in (run_k[0], run_p[0])])
    k1_fwd = k1_per_forward(fcfg)
    res["pyramid"] = {
        "diff": diff, "rel": loss_grad_rel(run_k, run_p),
        "per_level": dict(per_level),
        "launches": {k: v for k, v in pyr_launches.items() if v},
        "ms": cuda_ms(lambda: pyr_run(False), iters=3, warmup=1),
        "plain_ms": cuda_ms(lambda: pyr_run(True), iters=3, warmup=1)}
    want = {"pairwise_attention_fwd_warp": k1_fwd,
            "pairwise_attention_bwd_warp": k1_fwd}
    if res["pyramid"]["launches"] != want or per_level.get(0) or \
            per_level.get(1) or per_level.get(2) != {
                "pairwise_attention_fwd_warp": k1_fwd}:
        raise AssertionError(f"pyramid launches {pyr_launches}, per level "
                             f"{per_level} (want {want}, all forward ones at"
                             " level 2)")
    launches.update(pyr_launches)
    for part in ("transformer", "pyramid"):
        d, r = res[part]["diff"], res[part]["rel"]
        if any(d[k] > SLICE_TOL[k] for k in SLICE_TOL) or any(
                r[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
            raise AssertionError(f"{part} kernel vs plain {d}, {r}")
    del pyr, toks, spatial, temporal, run_k, run_p
    free_cuda()
    res["launches"] = dict(launches)
    return res


def phase_inductive_simulator(gen) -> dict:
    """(d): create_inductive_simulator('standard'): a token_mask forward
    against the plain path (routing pinned), and a remat-on backward
    against the same backward without remat."""
    bf = torch.bfloat16
    mla = dataclasses.replace(simulator_config("standard").mla,
                              use_flash_attention=True)
    t0 = time.perf_counter()
    sim, scfg = create_inductive_simulator(
        "standard", generator=gen, device="cuda", compute_dtype=bf,
        param_dtype=bf, mla=mla)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in sim.parameters())
    tokens = torch.randn((SIM_BATCH, SIM_TOKENS, scfg.hidden_dim),
                         generator=gen, device="cuda").to(bf)
    mask = MaskingStrategy(SIM_MASK_RATIO).random(gen, SIM_BATCH, SIM_TOKENS)
    sites = [n for n, m in sim.named_modules() if isinstance(m, MoELayer)]
    n_moe = len(sites)

    sim.eval()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        with gate_log() as log_k, plain_versions_refused():
            out_k = sim(tokens, mask)
        fwd_launches = {k: v for k, v in kernels.launch_counts.items() if v}
        modes = sorted({m.mode for m in sim.modules()
                        if isinstance(m, MoELayer)})
        with gate_log(log_k) as log_p, plain_versions():
            out_p = sim(tokens, mask)
        fwd_ms = cuda_ms(lambda: sim(tokens, mask), iters=3, warmup=1)
    diff = output_diff({"fused_representation": out_k, "reconstructions": {}},
                       {"fused_representation": out_p, "reconstructions": {}})
    shares = flipped_shares(sites, log_k, log_p)
    del out_k, out_p, log_k, log_p
    want = {"flash_attention_fwd": scfg.n_layers,
            "grouped_matmul_fwd": 3 * n_moe}
    if fwd_launches != want or modes != ["ragged"]:
        raise AssertionError(f"simulator forward launches {fwd_launches} "
                             f"(want {want}), modes {modes}")

    # the masked tokens' reconstruction, backward without and with remat,
    # in turns after a warm-up run (off, on, on, off): each setting's
    # numbers from its first timed run, its ms the lesser of its two
    sim.train()
    hidden = (~mask)[..., None].float()
    runs = {}
    free_cuda()
    for turn, remat in enumerate((False, False, True, True, False)):
        sim.transformer.remat = remat
        sim.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with plain_versions_refused():
            out = sim(tokens, mask, torch.Generator(device="cuda"))
            loss = (((out.float() - tokens.float()) ** 2) * hidden).sum() / (
                hidden.sum() * scfg.hidden_dim)
            loss.backward()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if turn and remat not in runs:
            runs[remat] = {
                "loss": loss.item(), "grad_norm": grad_norm_of(sim),
                "ms": ms, "peak_gib": torch.cuda.max_memory_allocated()
                / 2 ** 30, "launches": {k: v for k, v in
                                        kernels.launch_counts.items() if v}}
        elif turn:
            runs[remat]["ms"] = min(runs[remat]["ms"], ms)
        del out, loss
    sim.transformer.remat = False
    rel = {k: abs(runs[True][k] - runs[False][k]) / abs(runs[False][k])
           for k in ("loss", "grad_norm")}
    for name in ("flash_attention_fwd", "grouped_matmul_fwd"):
        if runs[True]["launches"].get(name, 0) != 2 * runs[False][
                "launches"].get(name, 0):
            raise AssertionError(f"simulator remat: {name} "
                                 f"{runs[True]['launches']} against "
                                 f"{runs[False]['launches']}")
    for name in ("flash_attention_bwd", "grouped_matmul_bwd_dlhs",
                 "grouped_matmul_bwd_drhs"):
        if runs[True]["launches"].get(name) != runs[False]["launches"].get(
                name) or not runs[False]["launches"].get(name):
            raise AssertionError(f"simulator remat: {name} "
                                 f"{runs[True]['launches']} against "
                                 f"{runs[False]['launches']}")
    del sim, tokens, mask, hidden
    free_cuda()
    if any(diff[k] > FLAGSHIP_TOL[k] for k in FLAGSHIP_TOL) or any(
            v > FLAGSHIP_MAX_FLIPPED for v in shares.values()):
        raise AssertionError(f"simulator kernel vs plain {diff}, flips "
                             f"{shares}")
    if any(rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"simulator remat vs no remat {rel}")
    total = collections.Counter(fwd_launches)
    for r in runs.values():
        total.update(r["launches"])
    return {"n_params": n_params, "build_s": build_s, "fwd_ms": fwd_ms,
            "fwd_launches": fwd_launches, "diff": diff, "shares": shares,
            "runs": runs, "rel": rel, "launches": dict(total)}


def phase_remat() -> dict:
    """Phase 22: remat on the flagship's train step, the C-stack, the
    A-stack blocks with the fusion pyramid, the inductive simulator; each
    part draws from a generator of its own seeded from SEED."""
    t0 = time.perf_counter()
    train = phase_remat_train()
    t_a = time.perf_counter()
    cs = phase_cstack(torch.Generator(device="cuda").manual_seed(SEED + 2))
    sh = cs["shared"]

    def steps(name):
        return ", ".join(f"{loss:.4f} / {ms:.1f} ms" for loss, ms in cs[name])
    t_b = time.perf_counter()
    print(f"[22b C-stack] bf16 over fp32 parameters | "
          f"BidirectionalReconstructor(full_vision_output=True) at "
          f"B={CSTACK_BIDIR_BATCH} (clips of 8 x 24 x 24 x 1408, language "
          f"7168; the (B, 8, 24, 24, 1408) grid out), make_bidirectional_step"
          f" x{CSTACK_STEPS} on one batch (loss / ms): {steps('bidirectional')}"
          f", peak {cs['bidirectional_peak']:.2f} GiB | MultimodalAutoencoder"
          f"({N_SPECIES} species) at B={CSTACK_AE_BATCH}, "
          f"make_autoencoder_step x{CSTACK_STEPS}: {steps('autoencoder')} | "
          f"MultimodalSharedSpace at B={CSTACK_SHARED_BATCH} over vision "
          f"(B, {VISION_PATCHES}, 1408) and language (B, 7168): 577 keys, "
          f"32 latents, 32-wide heads; forward launches {sh['fwd_launches']}"
          f" ({route_counts(sh['fwd_launches'], 'vmem_attention_fwd')}), "
          f"reconstruction-MSE step launches "
          + route_counts(sh["step_launches"], "vmem_attention_fwd",
                         "vmem_attention_bwd")
          + f"; forward {sh['fwd_ms']:.3f} ms, step {sh['ms']:.3f} ms; kernel"
          f" vs plain: outputs max {sh['diff']['max_abs']:.4g} mean "
          f"{sh['diff']['mean_abs']:.3g} (tol {SLICE_TOL}), loss / grad norm "
          f"rel {sh['rel']['loss']:.3g} / {sh['rel']['grad_norm']:.3g} (tol "
          f"{TRAIN_TOL}) | MultimodalUNet at B={CSTACK_UNET_BATCH} (30% of "
          f"the language features masked): {steps('unet')} | "
          f"BimodalMLPUNet({N_SPECIES}, 2048) image direction at "
          f"B={CSTACK_UNET_BATCH}: {steps('bimodal')}; species_topk(k=5) "
          f"{cs['topk_ms']:.3f} ms | the bidirectional, autoencoder and "
          f"U-Net paths launch no hand-written kernel (their attention has 4 "
          f"keys, or none) | {card()}")
    ab = phase_astack_blocks(torch.Generator(device="cuda").manual_seed(
        SEED + 3))
    t_c = time.perf_counter()
    tf, py = ab["transformer"], ab["pyramid"]
    print(f"[22c A-stack blocks] ModalityEncoder(1408 -> 768, 12 heads, "
          f"{ASTACK_LAYERS} layers) at B={ASTACK_ENC_BATCH}: "
          f"{ab['encoder_ms']:.3f} ms a forward, no kernel (one token) | "
          f"Transformer(768, 12 heads, {ASTACK_LAYERS} layers, interleaved "
          f"RoPE) over {VISION_PATCHES} tokens at B={ASTACK_TF_BATCH}, "
          f"forward + backward: launches {tf['launches']} ("
          + route_counts(tf["all_launches"], "vmem_attention_fwd",
                         "vmem_attention_bwd")
          + f"), {tf['ms']:.2f} ms (plain {tf['plain_ms']:.2f}); kernel vs "
          f"plain output max {tf['diff']['max_abs']:.4g} mean "
          f"{tf['diff']['mean_abs']:.3g}, loss / grad norm rel "
          f"{tf['rel']['loss']:.3g} / {tf['rel']['grad_norm']:.3g} | "
          f"HierarchicalFusion({HIER_LEVELS} levels) over the multimodal "
          f"fusion (512 wide, 4 layers) at B={HIER_BATCH}: 23, 13 and 8 "
          f"tokens; K1-fwd by level {py['per_level']} (the 8-token level "
          f"token-major, on K1's warp route past its streaming route's "
          f"{kernels.PAIRWISE_TMA_MAX_TOKENS} tokens), forward + backward "
          f"launches {py['launches']}, {py['ms']:.2f} ms (plain "
          f"{py['plain_ms']:.2f}); kernel vs plain outputs max "
          f"{py['diff']['max_abs']:.4g} mean {py['diff']['mean_abs']:.3g}, "
          f"loss / grad norm rel {py['rel']['loss']:.3g} / "
          f"{py['rel']['grad_norm']:.3g} (tol {SLICE_TOL}, {TRAIN_TOL}) | "
          f"{card()}")
    sim = phase_inductive_simulator(torch.Generator(
        device="cuda").manual_seed(SEED + 4))
    t_d = time.perf_counter()
    r0, r1 = sim["runs"][False], sim["runs"][True]
    print(f"[22d inductive simulator] create_inductive_simulator('standard')"
          f" (24 layers, 2048 wide, 16 heads, 8 experts; flash on), "
          f"{sim['n_params'] / 1e9:.4f}B params (bf16), built in "
          f"{sim['build_s']:.1f} s | B={SIM_BATCH} x {SIM_TOKENS} tokens, "
          f"{SIM_MASK_RATIO:.0%} masked: forward launches "
          f"{sim['fwd_launches']}, {sim['fwd_ms']:.2f} ms; kernel vs plain "
          f"(routing pinned) max {sim['diff']['max_abs']:.4g} mean "
          f"{sim['diff']['mean_abs']:.3g} (tol {FLAGSHIP_TOL}), flips mean "
          f"{statistics.mean(sim['shares'].values()):.3g} max "
          f"{max(sim['shares'].values()):.3g} (tol {FLAGSHIP_MAX_FLIPPED}) | "
          f"masked-token MSE forward + backward (CUDA events, the lesser of "
          f"two in turns after a warm-up): without remat {r0['ms']:.1f} ms, "
          f"peak "
          f"{r0['peak_gib']:.2f} GiB, launches {r0['launches']}; with remat "
          f"('full') {r1['ms']:.1f} ms, peak {r1['peak_gib']:.2f} GiB, "
          f"launches {r1['launches']}; loss / grad norm rel "
          f"{sim['rel']['loss']:.3g} / {sim['rel']['grad_norm']:.3g} (tol "
          f"{TRAIN_TOL}) | {card()}")
    print(f"[22 remat and model zoo] wall {t_d - t0:.1f} s (a "
          f"{t_a - t0:.1f}, b {t_b - t_a:.1f}, c {t_c - t_b:.1f}, d "
          f"{t_d - t_c:.1f})")
    total = collections.Counter()
    for part in (train, cs, ab, sim):
        total.update(part["launches"])
    return {"launches": dict(total), "train": train}


# phase 23: Gaussian splatting at tools/bench_splat.py's width (256 x 256,
# fx = fy = 220, the camera at z = 2.5, init_scene at extent 1, tiles of 16,
# K = 512, 3.5 sigma), the /visualizer route, and the export of the
# service's A-stack
SPLAT_SIZE, SPLAT_TILE, SPLAT_K = 256, 16, 512
SPLAT_TILED_G = (2_000, 16_000, 65_536, 262_144)
SPLAT_DENSE_G = (2_000, 16_000)
SPLAT_TRAIN = (("tiled", 65_536), ("dense", 2_000))
SPLAT_STEPS, SPLAT_LR = 3, 1e-2
# K8 is exact. K9-fwd rounds its colour sums and transmittance product in
# another order than the plain version's cumprod and einsum (a list in
# runs, the runs combined), an error that grows like the square root of
# the list's length: 1e-5 of the image's largest entry for the tiles'
# 512-entry lists, 1e-4 for the dense image's thousands. K9-bwd divides
# each entry's (1 - alpha) back out of the transmittance after its run and
# its dense sums meet in atomics in any order: each gradient within 1e-4
# (tiles) or 1e-3 (dense) of its largest entry.
SPLAT_IMAGE_TOL = {"tiled": 1e-5, "dense": 1e-4}
SPLAT_GRAD_TOL = {"tiled": 1e-4, "dense": 1e-3}
# the train steps: Adam divides each gradient entry by its own size, so an
# entry whose sum over the pixels nearly cancels (its sign set by rounding)
# could move up to 2 lr the other way in one run. The losses agree to 1e-5,
# at most 0.1% of the scene's entries may part by more than 1e-4, and none
# by more than 2 lr, one Adam step turned round (readings: no entry past
# 1e-4, the largest difference 3.8e-5).
SPLAT_TRAIN_TOL = {"loss_rel": 1e-5, "share_off": 1e-3, "off": 1e-4,
                   "max": 2 * SPLAT_LR}
# fp32 operations per (pixel, list entry) that the function itself needs,
# without any design's bookkeeping (the transmittance's renormalisation,
# the runs' state and their combination, the zero test, indexing). Alpha: dx, dy,
# the quadratic form (8), its scale, the opacity, the clip (14) and an exp.
# K9-fwd: alpha, the weight, three colour FMAs, the transmittance (23).
# K9-bwd: alpha; 1 - alpha and the transmittance before the entry (2);
# d alpha (9); the weight and d colour (4); the colour behind (9); the
# clip's gradient (2); d opacity (1); d q (2); d abc (5); d xy (10); the
# sum over the pixels of the nine gradients (9): 67 and one exp. K8: the
# hit test per (tile, Gaussian read) (7).
SPLAT_FWD_OPS, SPLAT_BWD_OPS, SPLAT_BIN_OPS = 23, 67, 7
# the final transmittance a pixel, what the function must hand its
# gradient; K9's per-run state (20 B a pixel and run) is its design's cost
SPLAT_FINAL_BYTES = 2 * 4
SPLAT_ENTRY_BYTES = 9 * 4  # xy, abc, opacity, colour of a list entry
SPLAT_GAUSSIAN_BYTES = 2 * 4 + 4 + 1  # xy, radius, valid of a Gaussian
ADAPTIVE = {"n_init": 256, "steps": 60, "densify_every": 20,
            "densify_until": 41, "lr": 2e-2, "extent": 0.5,
            "grad_threshold": 1e-7, "split_scale": 0.04}
EXPORT_BATCH = 64


def splat_bin_edges(device) -> dict:
    """K8's edge cases, drawn with numpy from SEED: name -> (xy, radius,
    valid, tiles_x, tiles_y, tile_size, k, chunk) on ``device``, chunk
    small enough that chunk boundaries fall inside the tiles' first k. The
    tests hold them against JAX's top_k on the CPU and the kernel against
    both plain versions on the card, as phase 23 does."""
    rng = np.random.default_rng(SEED)

    def spread(g, size, r_lo=1.0, r_hi=24.0):
        return (rng.uniform(-8, size + 8, (g, 2)), rng.uniform(r_lo, r_hi, g),
                np.ones(g, bool))

    cases = {}
    # box edges exactly on tile centres: |x - centre| == 8 + r in fp32
    xy, r, v = spread(64, 64)
    centre = 8.0 + 16.0 * rng.integers(0, 4, 64)
    r = rng.choice([0.5, 1.25, 3.0, 7.75, 20.5], 64)
    sign = rng.choice([-1.0, 1.0], 64)
    xy[:, 0] = centre + sign * (8.0 + r)
    xy[::3, 1] = 8.0 + 16.0 * rng.integers(0, 4, 22) + 8.0 + r[::3]
    xy[1::5, 0] = np.nextafter(xy[1::5, 0].astype(np.float32),
                               np.float32(np.inf))
    cases["edge_on_centre"] = (xy, r, v, 4, 4, 16, 16, 16)
    # infinite, negative and NaN reaches; infinite means
    xy, r, v = spread(40, 64)
    r[:4] = np.inf
    r[4:7] = -np.inf
    r[7:10] = -3.0
    r[10:12] = -8.0  # a reach of exactly 0
    r[12:14] = np.nan
    xy[14, 0], r[14] = np.inf, np.inf
    xy[15, 1], r[15] = -np.inf, 5.0
    cases["inf_radius"] = (xy, r, v, 4, 4, 16, 8, 8)
    # means of +-1e30, with reaches below, at and past them
    xy, r, v = spread(48, 64)
    xy[:24:2, 0] = 1e30
    xy[1:24:2, 1] = -1e30
    r[:8] = 1e30
    r[8:16] = 3e30
    cases["huge_xy"] = (xy, r, v, 4, 4, 16, 12, 5)
    # means far off screen whose box edge falls on screen: p - centre
    # rounds by up to 128 px there, so the superset needs its e
    p = rng.choice([3e8, -7e8, 2e9], 64) * rng.uniform(1, 1.01, 64)
    edge = rng.uniform(-40, 300, 64)
    xy, r, v = spread(64, 256)
    xy[np.arange(64), rng.integers(0, 2, 64)] = p
    r = np.abs(p - edge) - 8.0
    cases["far_rounding"] = (xy, r, v, 16, 16, 16, 24, 16)
    # NaN means (valid), NaN radii
    xy, r, v = spread(40, 64)
    xy[:6, 0] = np.nan
    xy[6:10, 1] = np.nan
    r[10:13] = np.nan
    cases["nan_xy_valid"] = (xy, r, v, 4, 4, 16, 8, 8)
    xy, r, v = spread(30, 64)
    cases["all_invalid"] = (xy, r, np.zeros(30, bool), 4, 4, 16, 8, 8)
    xy, r, v = spread(50, 64, 20.0, 60.0)
    v[::7] = False
    cases["k_equals_g"] = (xy, r, v, 4, 4, 16, 50, 16)
    xy, r, v = spread(200, 80)
    xy[:, 1] *= 48 / 80
    cases["non_square"] = (xy, r, v, 5, 3, 16, 30, 32)
    xy, r, v = spread(300, 64, 16.0, 40.0)
    cases["chunk_inside_first_k"] = (xy, r, v, 4, 4, 16, 64, 7)
    xy, r, v = spread(101, 64)
    cases["g_not_multiple"] = (xy, r, v, 4, 4, 16, 20, 32)
    xy = rng.uniform(28, 36, (400, 2))
    cases["chunks_past_k"] = (xy, rng.uniform(2, 6, 400),
                              np.ones(400, bool), 4, 4, 16, 8, 16)
    xy, r, v = spread(120, 70)
    xy[:, 1] *= 40 / 70
    cases["tile_of_10"] = (xy, r, v, 7, 4, 10, 16, 24)
    return {name: (torch.tensor(xy, dtype=torch.float32, device=device),
                   torch.tensor(r, dtype=torch.float32, device=device),
                   torch.tensor(v, device=device), *rest)
            for name, (xy, r, v, *rest) in cases.items()}


def splat_bin_grids(device) -> dict:
    """K8 on grids larger than phase 23's, drawn with numpy from SEED:
    1024 x 1024 pixels (T = 4,096, one window of its counters), 2048 x
    2048 (T = 16,384, three windows of rows) and 80,000 x 32 (5,000 x 2
    tiles, windows along the row), as splat_bin_edges gives its cases
    (chunk: kernels.splat_bin_chunk(G))."""
    rng = np.random.default_rng(SEED + 1)
    cases = {}
    for name, g, tiles_x, tiles_y, k, r_hi in (
            ("grid_1024px", 3000, 64, 64, 64, 120.0),
            ("grid_2048px", 3000, 128, 128, 32, 300.0),
            ("grid_5000x2_tiles", 1500, 5000, 2, 16, 2000.0)):
        size = np.array([tiles_x, tiles_y]) * 16
        xy = rng.uniform(-20, size + 20, (g, 2))
        cases[name] = (torch.tensor(xy, dtype=torch.float32, device=device),
                       torch.tensor(rng.uniform(4.0, r_hi, g),
                                    dtype=torch.float32, device=device),
                       torch.tensor(rng.uniform(size=g) > 0.1,
                                    device=device),
                       tiles_x, tiles_y, 16, k, None)
    return cases


def splat_bin_at(binning, chunk: Optional[int]):
    """kernels.splat_bin with chunks of ``chunk`` (None:
    kernels.splat_bin_chunk's)."""
    if chunk is None:
        return kernels.splat_bin(*binning)
    with mock.patch.object(kernels, "splat_bin_chunk", lambda g: chunk):
        return kernels.splat_bin(*binning)


def splat_bin_edge_check() -> str:
    """K8 bit for bit against bin_tiles_plain and bin_tiles_chunked_plain
    at splat_bin_edges' cases and splat_bin_grids' grids, launched twice
    (bitwise equal), one splat_bin launch a call; raises on a mismatch."""
    done = []
    for name, (*binning, chunk) in (splat_bin_edges("cuda")
                                    | splat_bin_grids("cuda")).items():
        ref = splat.bin_tiles_plain(*binning)
        kernels.reset_launch_counts()
        got = splat_bin_at(binning, chunk)
        again = splat_bin_at(binning, chunk)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            (*got, *again, *splat.bin_tiles_chunked_plain(*binning, chunk)),
            ref * 3))
        if not same or kernels.launch_counts["splat_bin"] != 2:
            raise AssertionError(f"K8 at {name}: not the plain lists, or "
                                 f"{kernels.launch_counts['splat_bin']} "
                                 f"launches for 2 calls")
        done.append(f"{name} (G={binning[0].shape[0]}, {binning[3]} x "
                    f"{binning[4]} tiles, k={binning[6]}, "
                    f"{float(ref[1].float().mean()) / binning[6]:.0%} filled)")
    return "bit for bit both plain versions: " + ", ".join(done)


# other chunks for K8 than kernels.splat_bin_chunk's, for --splat-bin
SPLAT_BIN_CHUNKS = (32, 64, 128, 256)


def splat_bin_times() -> None:
    """K8 alone at phase 23's tiled G (each scene init_scene from a
    generator seeded SEED + 5, phase 23's camera): ms by CUDA-graph
    replays and by CUDA events over the wrapper's calls, beside the
    Gaussians the longest tile reads, the tests of all tiles' scans and
    the slots filled, the lists bit for bit bin_tiles_plain's. Run from
    another tree's root, it times that tree's K8 the same way."""
    cam = splat_camera()
    rows = []
    for g in SPLAT_TILED_G:
        scene = gaussian_splat.init_scene(
            torch.Generator(device="cuda").manual_seed(SEED + 5), g)
        inp = splat_inputs(scene, cam, "tiled")
        binning = inp["binning"]
        ref = splat.bin_tiles_plain(*binning)
        if not (torch.equal(ref[0], inp["idx"])
                and torch.equal(ref[1], inp["count"])):
            raise AssertionError(f"K8 vs plain at G={g}")
        ms = graph_ms(lambda: kernels.splat_bin(*binning))
        events = cuda_ms(lambda: kernels.splat_bin(*binning), iters=20)
        passes = ", ".join(
            f"{kernel_label(name)} {dev_ms * 1e3:.2f} us"
            for name, dev_ms, _ in kernel_breakdown(
                lambda: kernels.splat_bin(*binning), n_calls=10)[0]
            if "splat_bin" in name)
        # other chunks than kernels.splat_bin_chunk's, where the tree has
        # them
        chunk = getattr(kernels, "splat_bin_chunk", None)
        others = "".join(
            f", chunk {c}: {graph_ms(lambda: splat_bin_at(binning, c)):.4f}"
            for c in SPLAT_BIN_CHUNKS if chunk and c != chunk(g))
        rows.append(f"G={g}: {ms:.4f} ms (events {events:.4f}; the "
                    f"profiler's device time a call: {passes}{others}); "
                    f"read {inp['read']}, scanned {inp['scanned']}, filled "
                    f"{float(inp['count'].float().mean()) / binning[6]:.1%}")
    print(f"[splat bin] K8 of {kernels.build().name} at {SPLAT_SIZE} x "
          f"{SPLAT_SIZE}, K = {SPLAT_K}, by CUDA-graph replays: "
          + " | ".join(rows) + f" | {card()}")


def splat_camera() -> Camera:
    return Camera(torch.eye(3, device="cuda"),
                  torch.tensor([0.0, 0.0, 2.5], device="cuda"), 220.0, 220.0,
                  SPLAT_SIZE / 2, SPLAT_SIZE / 2, SPLAT_SIZE, SPLAT_SIZE)


def splat_inputs(scene, cam, kind: str) -> dict:
    """What render / render_tiled hand K8 and K9 (their own
    gaussian_splat.dense_lists / tile_lists), with the (pixel, entry)
    pairs K9 composites over filled slots and, tiled, the Gaussians K8
    reads: each tile's up to its K-th hit, or all G."""
    if kind == "dense":
        lists = gaussian_splat.dense_lists(scene, cam)
        return {"lists": lists.lists, "geometry": lists.geometry,
                "pairs": SPLAT_SIZE * SPLAT_SIZE * scene.means.shape[0]}
    lists = gaussian_splat.tile_lists(scene, cam, tile_size=SPLAT_TILE,
                                      max_per_tile=SPLAT_K)
    idx, count = lists.idx, lists.count
    scanned = torch.where(count == idx.shape[1], idx[:, -1].long() + 1,
                          torch.full_like(count, scene.means.shape[0]).long())
    return {"binning": lists.binning, "idx": idx, "count": count,
            "lists": lists.lists, "geometry": lists.geometry,
            "pairs": int(count.sum()) * SPLAT_TILE * SPLAT_TILE,
            "scanned": int(scanned.sum()), "read": int(scanned.max())}


def splat_bounds(inp: dict) -> dict:
    """Each kernel's bound at these inputs (fp32 operations at the fp32
    peak, bytes at the HBM rate), and K9's exp floor: K9-fwd as a render
    calls it (the image written), K9-bwd reading the lists, dout and the
    kept transmittance and writing the lists' gradients."""
    lists_bytes = nbytes(*inp["lists"])
    pixels = SPLAT_SIZE * SPLAT_SIZE
    image = 3 * 4 * pixels
    out = {"fwd": bound(lists_bytes + image, SPLAT_FWD_OPS * inp["pairs"],
                        torch.float32),
           "bwd": bound(2 * lists_bytes + image + SPLAT_FINAL_BYTES * pixels,
                        SPLAT_BWD_OPS * inp["pairs"], torch.float32)}
    out["fwd"]["exp_floor_ms"] = exp_floor_ms(inp["pairs"])
    out["bwd"]["exp_floor_ms"] = exp_floor_ms(inp["pairs"])
    if "binning" in inp:
        out["bin"] = bound(SPLAT_GAUSSIAN_BYTES * inp["read"]
                           + nbytes(inp["idx"], inp["count"]),
                           SPLAT_BIN_OPS * inp["scanned"], torch.float32)
    return out


def splat_kernels(scene, cam, kind: str, gen, backward: bool) -> dict:
    """K8 (tiled), K9-fwd and, with ``backward``, K9-bwd at one scene's
    inputs: held against their plain versions, timed by CUDA events beside
    them and their bounds."""
    inp = splat_inputs(scene, cam, kind)
    lists, geometry = inp["lists"], inp["geometry"]
    out = {"bounds": splat_bounds(inp), "pairs": inp["pairs"]}
    if kind == "tiled":
        binning = inp["binning"]
        # K8 bit for bit against both plain versions, and a second launch
        # bit for bit the render's
        got = (*splat.bin_tiles_plain(*binning),
               *splat.bin_tiles_chunked_plain(*binning),
               *kernels.splat_bin(*binning))
        if not all(torch.equal(a, b) for a, b in zip(
                got, (inp["idx"], inp["count"]) * 3)):
            raise AssertionError(f"K8 vs plain at G={scene.means.shape[0]}")
        # by CUDA-graph replays (events over the wrapper's calls read its
        # host time), and by events beside them
        out["bin_ms"] = graph_ms(lambda: kernels.splat_bin(*binning))
        out["bin_events_ms"] = cuda_ms(lambda: kernels.splat_bin(*binning),
                                       iters=20)
        out["bin_plain_ms"] = cuda_ms(
            lambda: splat.bin_tiles_plain(*binning), iters=3, warmup=1)
        out["filled"] = float(inp["count"].float().mean() / inp["idx"].shape[1])
        out["read"], out["scanned"] = inp["read"], inp["scanned"]
    img = kernels.splat_composite_fwd(*lists, None, *geometry)
    ref = splat.composite_plain(*lists, None, *geometry)
    out["fwd_err"] = max_err(img, ref) / ref.abs().max().item()
    out["fwd_abs_err"] = max_err(img, ref)
    # the mean signed error of the kernel's image and the plain one against
    # the plain arithmetic in float64, relative to each entry (from 1e-3)
    exact = splat.composite_plain(*(t.double() for t in lists), None,
                                  *geometry)
    for key, got in (("fwd_bias", img), ("fwd_plain_bias", ref)):
        out[key] = float(((got.double() - exact)
                          / exact.abs().clamp_min(1e-3)).mean())
    del exact
    if out["fwd_err"] > SPLAT_IMAGE_TOL[kind]:
        raise AssertionError(f"K9-fwd vs plain, {kind} G="
                             f"{scene.means.shape[0]}: {out['fwd_err']:.3g} "
                             f"of the largest entry")
    # K9's device time by CUDA-graph replays (a tiled call is shorter than
    # the wrapper's host time, which events over back-to-back calls read),
    # and by events as PR 19's phase took it
    out["fwd_ms"] = graph_ms(
        lambda: kernels.splat_composite_fwd(*lists, None, *geometry))
    out["fwd_events_ms"] = cuda_ms(
        lambda: kernels.splat_composite_fwd(*lists, None, *geometry), iters=10)
    out["fwd_plain_ms"] = cuda_ms(
        lambda: splat.composite_plain(*lists, None, *geometry), iters=2,
        warmup=1)
    if not backward:
        return out
    dout = torch.randn(img.shape, generator=gen, device="cuda")
    _, state = kernels.splat_composite_fwd(*lists, None, *geometry,
                                           keep_state=True)
    grads = kernels.splat_composite_bwd(*lists, None, state, dout,
                                        *geometry)
    ref_grads = splat.composite_bwd_plain(*lists, None, dout, *geometry)
    out["bwd_err"] = max(max_err(g, r) / r.abs().max().item()
                         for g, r in zip(grads[:4], ref_grads[:4]))
    out["bwd_abs_err"] = max(max_err(g, r)
                             for g, r in zip(grads[:4], ref_grads[:4]))
    if out["bwd_err"] > SPLAT_GRAD_TOL[kind]:
        raise AssertionError(f"K9-bwd vs plain, {kind} G="
                             f"{scene.means.shape[0]}: {out['bwd_err']:.3g} "
                             f"of the largest entry")
    out["bwd_ms"] = graph_ms(lambda: kernels.splat_composite_bwd(
        *lists, None, state, dout, *geometry))
    out["bwd_events_ms"] = cuda_ms(lambda: kernels.splat_composite_bwd(
        *lists, None, state, dout, *geometry), iters=10)
    out["bwd_plain_ms"] = cuda_ms(lambda: splat.composite_bwd_plain(
        *lists, None, dout, *geometry), iters=2, warmup=1)
    return out


def splat_train(gen, kind: str, g: int) -> dict:
    """SPLAT_STEPS make_train_step steps (forward, backward, Adam) on one
    scene, with the kernels and through the plain versions from the same
    state; the target is another scene's render."""
    cam = splat_camera()
    render = (gaussian_splat.render if kind == "dense"
              else gaussian_splat.render_tiled)
    with torch.no_grad():
        target = render(gaussian_splat.init_scene(gen, g), cam)
    start = gaussian_splat.init_scene(gen, g)
    runs = {}
    for plain in (False, True):
        init, step = gaussian_splat.make_train_step(cam, SPLAT_LR, kind)
        scene, opt, losses, ms = start, init(start), [], []
        kernels.reset_launch_counts()
        with plain_versions() if plain else plain_versions_refused():
            for _ in range(SPLAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scene, opt, loss = step(scene, opt, target)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
        runs[plain] = {"scene": scene, "losses": losses, "ms": ms,
                       "launches": dict(kernels.launch_counts)}
    want = expected_launches(splat_bin=SPLAT_STEPS if kind == "tiled" else 0,
                             splat_composite_fwd=SPLAT_STEPS,
                             splat_composite_bwd=SPLAT_STEPS)
    if runs[False]["launches"] != want:
        raise AssertionError(f"{kind} train steps: launches "
                             f"{runs[False]['launches']} != {want}")
    k, p = runs[False], runs[True]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                       p["losses"]))
    diff = torch.cat([(a - b).abs().flatten()
                      for a, b in zip(k["scene"], p["scene"])])
    share = float((diff > SPLAT_TRAIN_TOL["off"]).float().mean())
    if (loss_rel > SPLAT_TRAIN_TOL["loss_rel"]
            or share > SPLAT_TRAIN_TOL["share_off"]
            or float(diff.max()) > SPLAT_TRAIN_TOL["max"]
            or not all(torch.isfinite(t).all() for t in k["scene"])):
        raise AssertionError(f"{kind} G={g} train steps, kernel vs plain: "
                             f"loss rel {loss_rel:.3g}, share off {share:.3g}"
                             f", largest difference {float(diff.max()):.3g}"
                             f" (tol {SPLAT_TRAIN_TOL})")
    return {"losses": k["losses"], "plain_losses": p["losses"],
            "ms": k["ms"], "plain_ms": p["ms"], "loss_rel": loss_rel,
            "share_off": share, "max_param_diff": float(diff.max()),
            "launches": k["launches"]}


def splat_adaptive(gen) -> dict:
    """fit_scene_adaptive on the tiled renderer against the render of a
    tight cluster of bright Gaussians (the JAX package's densification
    test at 256 x 256): at least one densify must resize the scene and the
    loss must fall."""
    cam = splat_camera()
    true = gaussian_splat.init_scene(gen, 48, extent=0.15)
    true = true._replace(
        opacity_logits=torch.full((48,), 2.5, device="cuda"),
        colors=torch.randn((48, 3), generator=gen, device="cuda") * 2)
    with torch.no_grad():
        target = gaussian_splat.render_tiled(true, cam)
        first = gaussian_splat.init_scene(
            torch.Generator(device="cuda").manual_seed(SEED),
            ADAPTIVE["n_init"], ADAPTIVE["extent"])
        loss0 = float(torch.mean(
            (gaussian_splat.render_tiled(first, cam) - target) ** 2))
    resizes = []
    densify = gaussian_splat.densify_and_prune

    def counting(scene, *args, **kw):
        new, src = densify(scene, *args, **kw)
        resizes.append((scene.means.shape[0], new.means.shape[0]))
        return new, src
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(gaussian_splat, "densify_and_prune", counting), \
            plain_versions_refused():
        scene, loss = gaussian_splat.fit_scene_adaptive(
            target, cam, renderer="tiled", seed=SEED, **ADAPTIVE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    steps = ADAPTIVE["steps"]
    want = expected_launches(splat_bin=steps, splat_composite_fwd=steps,
                             splat_composite_bwd=steps)
    if launches != want:
        raise AssertionError(f"adaptive fit: launches {launches} != {want}")
    if not resizes or all(a == b for a, b in resizes):
        raise AssertionError(f"adaptive fit: no densify resized: {resizes}")
    if not (math.isfinite(loss) and loss < 0.5 * loss0):
        raise AssertionError(f"adaptive fit: loss {loss0} -> {loss}")
    return {"loss0": loss0, "loss": loss, "resizes": resizes,
            "g": scene.means.shape[0], "seconds": seconds,
            "launches": launches}


# other splits of K9's lists than kernels.splat_plan's (segments, pixel
# groups a block), for --splat-plans
SPLAT_PLAN_SWEEP = {"tiled": ((4, 2), (8, 2), (2, 2), (8, 1)),
                    "dense": ((8, 1), (8, 2), (4, 1), (15, 1))}


def splat_plan_sweep() -> None:
    """K9-fwd (keeping its state) and K9-bwd at phase 23's tiled G = 65,536
    and dense G = 2,000 scenes under kernels.splat_plan's split and the
    others of SPLAT_PLAN_SWEEP: device ms by CUDA-graph replays, the median
    of 3 rounds over the splits, and the image against the plain one."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cam = splat_camera()
    for kind, g in (("tiled", 65_536), ("dense", 2_000)):
        inp = splat_inputs(gaussian_splat.init_scene(gen, g), cam, kind)
        lists, geometry = inp["lists"], inp["geometry"]
        dout = torch.randn((SPLAT_SIZE, SPLAT_SIZE, 3), generator=gen,
                           device="cuda")
        ref = splat.composite_plain(*lists, None, *geometry)
        plan = kernels.splat_plan(lists[0].shape[1], *geometry[2:])
        plans = (plan,) + tuple(p for p in SPLAT_PLAN_SWEEP[kind]
                                if p != plan)
        times = {p: ([], []) for p in plans}
        errs = {}
        for _ in range(3):
            for p in plans:
                with mock.patch.object(kernels, "splat_plan",
                                       lambda k, h, w, p=p: p):
                    img, state = kernels.splat_composite_fwd(
                        *lists, None, *geometry, keep_state=True)
                    errs[p] = max_err(img, ref) / ref.abs().max().item()
                    times[p][0].append(graph_ms(
                        lambda: kernels.splat_composite_fwd(
                            *lists, None, *geometry, keep_state=True)))
                    times[p][1].append(graph_ms(
                        lambda: kernels.splat_composite_bwd(
                            *lists, None, state, dout, *geometry)))
        print(f"[splat plans] {kind} G={g}, (segments, groups a block), "
              f"kernels.splat_plan's first: " + "; ".join(
                  f"{p}: K9-fwd {statistics.median(f):.4f} ms, K9-bwd "
                  f"{statistics.median(b):.4f} ms, image err {errs[p]:.2g}"
                  for p, (f, b) in times.items()) + f" | {card()}")


def splat_visualizer() -> dict:
    """DataService(viewer_views=...) answers GET /visualizer on 127.0.0.1
    with reconstruction.render_viewer_html of its views: two views of
    depth maps unprojected with the splat camera's intrinsics."""
    rng = np.random.default_rng(SEED)
    k = CameraIntrinsics(fx=220.0, fy=220.0, cx=SPLAT_SIZE / 2,
                         cy=SPLAT_SIZE / 2, width=SPLAT_SIZE,
                         height=SPLAT_SIZE)
    views = [ViewCloud(
        points_cam=unproject_depth(
            rng.uniform(1.0, 4.0, (SPLAT_SIZE, SPLAT_SIZE)), k,
            stride=4).astype(np.float32),
        colors=rng.integers(0, 256, ((SPLAT_SIZE // 4) ** 2, 3)).astype(
            np.uint8),
        rotation_body_to_world=euler_adjust_matrix(0, 0, 30 * i),
        translation=np.array([0.1 * i, 0.0, 0.0]), name=f"view {i}")
        for i in range(2)]
    srv = DashboardServer(DataService(viewer_views=views), port=0).start()
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/visualizer", timeout=60) as r:
            status, body = r.status, r.read().decode()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        srv.stop()
    if status != 200 or body != render_viewer_html(views):
        raise AssertionError(f"/visualizer: status {status}, body of "
                             f"{len(body)} characters is not the viewer's")
    return {"bytes": len(body), "ms": ms,
            "points": sum(len(v.points_cam) for v in views)}


def splat_export() -> dict:
    """export_model_forward of the A-stack api.DeepEarth serves (the quick
    start's sources at hidden 768, 12 layers), reloaded with load_exported:
    the program launches K1-fwd and K2-fwd through their operators, as
    often as the eager forward, and gives its outputs bit for bit."""
    earth = register_quick_start(DeepEarth(**API_WIDTH))
    job = api_batch(SEED, EXPORT_BATCH)
    earth.predict_batch(**job)  # builds the model
    model = earth._model
    batch = earth._prepare_batch(job["locations"], job["times"], job["data"])
    per_forward = {"grid4d_encode_fwd": K2_PER_FORWARD,
                   k1_fwd_counter(SERVICE_TOKENS): K1_PER_FORWARD}
    t0 = time.perf_counter()
    blob = export_model_forward(model, None, batch)
    export_s = time.perf_counter() - t0
    fn = load_exported(blob)
    (fused, recon), launches = counted(lambda: fn(batch), per_forward,
                                       "the exported A-stack")

    def eager():
        with torch.no_grad():
            return model(batch)
    ref, _ = counted(eager, per_forward, "the eager A-stack")
    same = torch.equal(fused, ref["fused_representation"]) and all(
        torch.equal(recon[k], ref["reconstructions"][k]) for k in recon)
    if not same or recon.keys() != ref["reconstructions"].keys():
        err = max_err(fused, ref["fused_representation"])
        raise AssertionError(f"exported A-stack vs eager: max {err}")
    targets = {n.target for n in torch.export.load(
        io.BytesIO(blob)).graph_module.graph.nodes if n.op == "call_function"}
    ops = sorted(str(t) for t in targets if str(t).startswith("deepearth."))
    return {"bytes": len(blob), "export_s": export_s, "launches": launches,
            "ops": ops,
            "ms": statistics.median(host_ms(lambda: fn(batch), iters=5)),
            "eager_ms": statistics.median(host_ms(eager, iters=5))}


def phase_splat() -> dict:
    """Phase 23: Gaussian splatting, the viewer and the export; its
    generator seeded from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t0 = time.perf_counter()
    cam = splat_camera()
    tiled, dense, main = {}, {}, collections.Counter()
    for kind, sizes, table, render in (
            ("tiled", SPLAT_TILED_G, tiled, gaussian_splat.render_tiled),
            ("dense", SPLAT_DENSE_G, dense, gaussian_splat.render)):
        for g in sizes:
            scene = gaussian_splat.init_scene(gen, g)
            want = ({"splat_bin": 1} if kind == "tiled" else {}) | {
                "splat_composite_fwd": 1}
            with torch.no_grad():
                img, launches = counted(lambda: render(scene, cam), want,
                                        f"render {kind} G={g}")
                with plain_versions():
                    ref = render(scene, cam)
            main.update(launches)
            if img.shape != (SPLAT_SIZE, SPLAT_SIZE, 3) or not torch.isfinite(
                    img).all():
                raise AssertionError(f"{kind} G={g}: {img.shape} or "
                                     f"non-finite values")
            # K9-bwd at the train steps' sizes: the plain backward keeps
            # every (pixel, entry) intermediate, 42 GB at the dense 16,000
            row = splat_kernels(scene, cam, kind, gen, backward=(
                kind == "tiled" or (kind, g) in SPLAT_TRAIN))
            row["render_err"] = max_err(img, ref) / ref.abs().max().item()
            if row["render_err"] > SPLAT_IMAGE_TOL[kind]:
                raise AssertionError(f"render {kind} G={g} vs plain: "
                                     f"{row['render_err']:.3g}")
            with torch.no_grad():
                row["render_ms"] = cuda_ms(lambda: render(scene, cam),
                                           iters=10)
                with plain_versions():
                    row["render_plain_ms"] = cuda_ms(
                        lambda: render(scene, cam), iters=2, warmup=1)
            table[g] = row
    edges = splat_bin_edge_check()
    t_render = time.perf_counter()
    train = {}
    for kind, g in SPLAT_TRAIN:
        train[kind] = splat_train(gen, kind, g)
        main.update(train[kind]["launches"])
    adaptive = splat_adaptive(gen)
    main.update(adaptive["launches"])
    t_train = time.perf_counter()
    viewer = splat_visualizer()
    exported = splat_export()
    t_end = time.perf_counter()

    def fmt_row(g, r):
        b = r["bounds"]

        def share(key):  # the unchanged bound over the kernel's time
            return f"{b[key]['bound_ms'] / r[key + '_ms']:.1%} of its bound"
        parts = [f"G={g}"]
        if "bin_ms" in r:
            parts.append(f"K8 {r['bin_ms']:.4f} ms ({share('bin')}; events "
                         f"{r['bin_events_ms']:.4f}; plain "
                         f"{r['bin_plain_ms']:.3f}, bound "
                         f"{b['bin']['bound_ms']:.4f} {b['bin']['bound_by']}"
                         f" over the {r['read']} Gaussians the longest tile "
                         f"reads, {r['scanned']} tests in all; slots filled "
                         f"{r['filled']:.1%})")
        parts.append(
            f"K9-fwd {r['fwd_ms']:.4f} ({share('fwd')}; events "
            f"{r['fwd_events_ms']:.4f}; plain {r['fwd_plain_ms']:.3f}, bound "
            f"{b['fwd']['bound_ms']:.4f} {b['fwd']['bound_by']}, exp floor "
            f"{b['fwd']['exp_floor_ms']:.4f}; err {r['fwd_err']:.2g}, bias "
            f"against float64 {r['fwd_bias']:.2g}, plain's "
            f"{r['fwd_plain_bias']:.2g})")
        if "bwd_ms" in r:
            parts.append(
                f"K9-bwd {r['bwd_ms']:.4f} ({share('bwd')}; events "
                f"{r['bwd_events_ms']:.4f}; plain {r['bwd_plain_ms']:.3f}, "
                f"bound {b['bwd']['bound_ms']:.4f} {b['bwd']['bound_by']}, "
                f"exp floor {b['bwd']['exp_floor_ms']:.4f}; err "
                f"{r['bwd_err']:.2g})")
        parts.append(f"render {r['render_ms']:.3f} ms (plain "
                     f"{r['render_plain_ms']:.3f}; err {r['render_err']:.2g})")
        return ", ".join(parts)
    print(f"[23a splat render] {SPLAT_SIZE} x {SPLAT_SIZE}, fx = fy = 220, "
          f"z = 2.5, init_scene extent 1, tiles of {SPLAT_TILE}, K = "
          f"{SPLAT_K}, 3.5 sigma; per scene: launches of each render "
          f"(counters reset before, read after) K8 1 + K9-fwd 1 tiled, "
          f"K9-fwd 1 dense; kernel vs plain (tol image {SPLAT_IMAGE_TOL}, "
          f"gradients {SPLAT_GRAD_TOL} of the largest entry; K8 exact); "
          f"kernel ms by CUDA-graph replays (events beside), the rest by "
          f"CUDA events | K8 at its edge cases and large grids: "
          f"{edges} | "
          f"tiled: "
          + " | ".join(fmt_row(g, r) for g, r in tiled.items())
          + " | dense: " + " | ".join(fmt_row(g, r) for g, r in dense.items())
          + f" | {card()}")
    tr = " | ".join(
        f"{kind} G={g}: losses {[round(x, 6) for x in train[kind]['losses']]}"
        f" (plain {[round(x, 6) for x in train[kind]['plain_losses']]}), "
        f"step ms {[round(x, 2) for x in train[kind]['ms']]} (plain "
        f"{[round(x, 2) for x in train[kind]['plain_ms']]}), loss rel "
        f"{train[kind]['loss_rel']:.3g}, entries off by > "
        f"{SPLAT_TRAIN_TOL['off']} {train[kind]['share_off']:.3g}, max "
        f"{train[kind]['max_param_diff']:.3g}"
        for kind, g in SPLAT_TRAIN)
    print(f"[23b splat training] make_train_step x{SPLAT_STEPS} (forward, "
          f"backward, Adam lr {SPLAT_LR}), kernel vs plain from one state "
          f"(tol {SPLAT_TRAIN_TOL}); K8 1 (tiled), K9-fwd 1, K9-bwd 1 a step"
          f" | {tr} | fit_scene_adaptive(tiled, {ADAPTIVE}): scene "
          f"{ADAPTIVE['n_init']} -> {adaptive['g']} by {adaptive['resizes']}"
          f", loss {adaptive['loss0']:.6f} -> {adaptive['loss']:.6f}, "
          f"{adaptive['seconds']:.2f} s, launches "
          f"{ {k: v for k, v in adaptive['launches'].items() if v} } | "
          f"{card()}")
    print(f"[23c viewer and export] GET /visualizer: {viewer['bytes']} "
          f"characters ({viewer['points']} points, 2 views), "
          f"{viewer['ms']:.1f} ms, the viewer's HTML | export_model_forward "
          f"of DeepEarth(768, 12) with the quick start's sources at "
          f"B={EXPORT_BATCH}: {exported['bytes']} bytes in "
          f"{exported['export_s']:.1f} s, operators {exported['ops']}; the "
          f"reloaded program's launches "
          f"{ {k: v for k, v in exported['launches'].items() if v} }, "
          f"outputs bit for bit the eager forward's; {exported['ms']:.2f} ms"
          f" a call (eager {exported['eager_ms']:.2f}) | {card()}")
    print(f"[23 splatting, viewer, export] wall {t_end - t0:.1f} s (renders "
          f"{t_render - t0:.1f}, training {t_train - t_render:.1f}, viewer "
          f"and export {t_end - t_train:.1f})")
    return {"tiled": tiled, "dense": dense, "train": train,
            "adaptive": adaptive, "viewer": viewer, "export": exported,
            "launches": dict(main)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--clip-batch-search", action="store_true",
                        help="only the flagship's train step at 4608 patches"
                             ": the largest batch that fits, without and "
                             "with remat")
    parser.add_argument("--flagship-train-spread", type=int, nargs="+",
                        metavar="SEED",
                        help="only phase 16's kernel-vs-plain train "
                             "comparison, once per seed")
    parser.add_argument("--splat-plans", action="store_true",
                        help="only K9 at phase 23's tiled and dense scenes "
                             "under other splits of its lists")
    parser.add_argument("--splat-bin", action="store_true",
                        help="only K8 at phase 23's tiled scenes, by "
                             "CUDA-graph replays")
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
    if args.splat_plans:
        splat_plan_sweep()
        return
    if args.splat_bin:
        splat_bin_times()
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
    svc = phase_service()
    cli = phase_cli()
    # phase 21 draws from a generator of its own seeded from SEED, as phases
    # 15 and 16 do: its draws do not move with the phases before it
    tok = phase_tokens(torch.Generator(device="cuda").manual_seed(SEED))
    remat = phase_remat()
    splats = phase_splat()
    report = {"kernels": [
        {"name": "grid4d_encode_fwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/grid4d_encode.cu",
         "replaces": "deepearth_tpu/ops/hash_encoding.py:113 (every table of"
                     " deepearth_tpu/models/grid4d.py:53-84 with its masks, "
                     "concatenation and cast)",
         "launches": sl["launches"]["grid4d_encode_fwd"],
         "launches_in_phase_19": svc["launches"]["grid4d_encode_fwd"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "composition_ms": k2["composition_ms"],
         "floor_ms": k2["floor_ms"]},
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
    # phase 23's kernels, at the tiled train step's scene (G = 65,536);
    # every scene's numbers under "at_G". No PyTorch call computes them.
    at = splats["tiled"][dict(SPLAT_TRAIN)["tiled"]]
    for name, key, replaces, exact in (
            ("splat_bin", "bin", ":253-259 (XLA: render_tiled's intersect "
             "test and lax.top_k)", True),
            ("splat_composite_fwd", "fwd", ":261-283 (XLA: render_tiled's "
             "compositing) and :143-157 (render's)", False),
            ("splat_composite_bwd", "bwd", ":261-283 and :143-157 (their "
             "gradient: jax.grad of XLA)", False)):
        rows = {f"{kind} {g}": r for kind in ("tiled", "dense")
                for g, r in splats[kind].items() if f"{key}_ms" in r}
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": "deepearth_tpu_torch/kernels/csrc/gaussian_splat.cu",
            "replaces": "deepearth_tpu/reconstruction/gaussian_splat.py"
                        + replaces,
            "launches": splats["launches"][name],
            "max_abs_err": 0.0 if exact else at[f"{key}_abs_err"],
            "ms": at[f"{key}_ms"], "plain_ms": at[f"{key}_plain_ms"],
            **{k: at["bounds"][key][k] for k in ("bound_ms", "bound_by")},
            "library_ms": None,
            # ms by graph replays, events_ms over the wrapper's calls
            "events_ms": at[f"{key}_events_ms"],
            "at_G": {tag: {"ms": r[f"{key}_ms"],
                           "events_ms": r[f"{key}_events_ms"],
                           "plain_ms": r[f"{key}_plain_ms"],
                           **r["bounds"][key],
                           "max_rel_err": 0.0 if exact else r[f"{key}_err"]}
                     for tag, r in rows.items()}})
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
                  "deepearth_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
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
    # the embedding service's 4 tokens take K1-fwd's warp route: on phase
    # 19's path, its launches there
    warp = "pairwise_attention_fwd_warp"
    report["off_main_path"] = [e for e in report["off_main_path"]
                               if e["name"] != warp]
    report["kernels"].insert(2, {
        **off_main(report["kernels"][1]), "launches": svc["launches"][warp],
        **{key: svc["kernels"][warp][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}})
    if k1_fwd_counter(SERVICE_TOKENS) != warp:
        raise AssertionError("phase 19's K1-fwd route is not the warp route")
    # the per-table K2-fwd: HashEncoding alone and Grid4D off the
    # one-launch route (F != 2), which no main path takes; its numbers are
    # the spatial table's alone at B=4096
    spatial = k2["table_bounds"]["spatial"]
    report["off_main_path"].append({
        "name": "hash_encode_fwd", "route": "cuda",
        "source": "deepearth_tpu_torch/kernels/csrc/hash_encode.cu",
        "replaces": "deepearth_tpu/ops/hash_encoding.py:113",
        "launches_in_phase_2": k2["launches"]["hash_encode_fwd"],
        "max_abs_err": k2["per_table_max_abs_err"],
        "ms": k2["table_times"]["spatial_kernel"],
        "plain_ms": k2["table_times"]["spatial_plain"],
        "bound_ms": spatial["bound_ms"], "bound_by": spatial["bound_by"],
        "library_ms": None})
    # phase 20's launches: the training CLI's and its --data-dir body's
    for entry in report["kernels"] + report["off_main_path"]:
        if cli["launches"].get(entry["name"]):
            entry["launches_in_phase_20"] = cli["launches"][entry["name"]]
    # K3 at the shapes phase 20's real-data path gives it
    for entry in report["kernels"]:
        direction = {"vmem_attention_fwd": "fwd",
                     "vmem_attention_bwd": "bwd"}.get(entry["name"])
        if direction:
            entry["max_abs_err_in_phase_20"] = cli["k3_max_abs_err"][direction]
    # phase 21: K4 at heads above 128 (its TMA route; the mma.sync and
    # CUDA-core routes' times beside), launched 3 times a forward and a
    # backward of the V3-width classifier; K3 in the text train step
    for entry in report["kernels"]:
        name = entry["name"]
        launched = (collections.Counter(tok["classifier"]["launches"])
                    + collections.Counter(tok["text"]["launches"])).get(name)
        if launched:
            entry["launches_in_phase_21"] = launched
        direction = {"flash_attention_fwd": "fwd",
                     "flash_attention_bwd": "bwd"}.get(name)
        if direction:
            for shape, numbers in tok["wide"][direction].items():
                key = "at_" + shape.split()[-1].replace("/", "_")
                entry[key] = {k: numbers[k] for k in (
                    "ms", "mma_ms", "fp32_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err",
                    "mma_max_abs_err", "fp32_max_abs_err")}
    # phase 22: remat on the flagship's train step, the C-stack, the A-stack
    # blocks and the fusion pyramid, the inductive simulator
    for entry in report["kernels"] + report["off_main_path"]:
        if remat["launches"].get(entry["name"]):
            entry["launches_in_phase_22"] = remat["launches"][entry["name"]]
    # phase 23: the exported A-stack's program (K1-fwd on its warp route,
    # K2-fwd), beside the splatting kernels' own entries
    for entry in report["kernels"] + report["off_main_path"]:
        if splats["export"]["launches"].get(entry["name"]):
            entry["launches_in_phase_23_export"] = (
                splats["export"]["launches"][entry["name"]])
    print(json.dumps(report))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
