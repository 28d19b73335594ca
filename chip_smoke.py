#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepearth_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device and build: requires CUDA, prints the card, builds the kernels;
  2. K2-fwd (hash_encode_fwd) against its plain PyTorch version on the card;
  3. K1-fwd (pairwise_attention_fwd) against its plain PyTorch version;
  4. the serving slice: DeepEarthModel at the A-stack configuration (hidden
     768, 12 heads, 12 fusion layers, Grid4D 16 levels on 2^19 tables + 8 on
     2^17, species vocab 232, bf16 compute) answers requests of 1, 37 and
     4096 observations; every forward must launch K2-fwd twice and K1-fwd 16
     times, and its outputs must agree with the same model run through the
     plain versions;
  5. K1-bwd (pairwise_attention_bwd) against its plain PyTorch version;
  6. K2-bwd (hash_encode_bwd) against its plain PyTorch version;
  7. the training slice: the same model trained at B=4096 with masking
     through Trainer.fit and Trainer.evaluate; every train step must launch
     K2-fwd 2, K2-bwd 2, K1-fwd 16 and K1-bwd 16 times; 3 steps with the
     kernels must agree with 3 steps through the plain versions from the
     same state; the loss must fall over 30 steps on one repeated batch;
  8. K3-fwd (vmem_attention_fwd) against its plain PyTorch version, in bf16
     and fp32, at the multimodal slice's two sites (B=512), a ragged masked
     case with an all-masked row (exactly 0) and Nk = 1024;
  9. the multimodal serving slice: DeepEarthModel at the configuration of
     tools/bench_multimodal.py (universal dim 512, 8 heads, 4 fusion layers,
     species + vision (576 V-JEPA2 patches of 1408) + language (7168), bf16)
     answers requests of 1, 32 and 512 observations; every forward must
     launch K3-fwd 2, K2-fwd 2 and K1-fwd 0 times and never reach a plain
     version, and its outputs must agree with the plain path's;
then a JSON line of the kernels, the card's name and power limit, and
{"ok": true, ...} as the last line. Any failure raises and exits non-zero.
Weights are random, drawn from a seeded generator on the card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import math
import subprocess
import time
from unittest import mock

import torch
import torch.nn.functional as F

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import (
    DeepEarthConfig,
    Grid4DConfig,
    ModalityConfig,
    TransformerConfig,
)
from deepearth_tpu_torch.models import DeepEarthModel, fusion
from deepearth_tpu_torch.ops import (
    attention_smallseq,
    attention_vmem,
    hash_encoding,
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
K3_PER_FORWARD = 2
# bf16 through the vision encoder (one MLA layer over 576 patches), the
# token cross-attention and 4 fusion layers: kernel and plain round
# differently, and the residual streams carry each difference on.
MM_SLICE_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


@contextlib.contextmanager
def plain_versions():
    """Route the model's two kernel sites to their plain PyTorch versions;
    in training, autograd through those plain forwards gives the plain
    backward."""
    with mock.patch.object(hash_encoding, "hash_encode",
                           hash_encoding.hash_encode_plain), \
         mock.patch.object(fusion, "pairwise_token_attention",
                           attention_smallseq.pairwise_token_attention_plain), \
         mock.patch.object(attention_vmem, "vmem_attention",
                           attention_vmem.vmem_attention_plain):
        yield


@contextlib.contextmanager
def plain_versions_refused():
    """Make every plain version raise: a run inside reaches none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")
    with mock.patch.object(hash_encoding, "hash_encode_plain", refuse), \
         mock.patch.object(attention_smallseq,
                           "pairwise_token_attention_plain", refuse), \
         mock.patch.object(attention_vmem, "vmem_attention_plain", refuse):
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
        if "registers" in line or "spill" in line:
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


def phase_attention(gen) -> dict:
    errs = {}

    def case(name, nq, nk, b, d, h, dtype, mask=None, fused_qkv=False):
        if fused_qkv:  # strided views of one projection, as the model has
            qkv = torch.randn((nq, b, 3 * d), generator=gen, device="cuda")
            q, k, v = qkv.to(dtype).chunk(3, dim=-1)
        else:
            q = torch.randn((nq, b, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((nk, b, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((nk, b, d), generator=gen, device="cuda").to(dtype)
        kw = dict(n_heads=h, scale=(d // h) ** -0.5, key_mask=mask)
        out = attention_smallseq.pairwise_token_attention(q, k, v, **kw)
        ref = attention_smallseq.pairwise_token_attention_plain(q, k, v, **kw)
        if out.shape != ref.shape or out.dtype != dtype:
            raise AssertionError(f"K1 {name}: {out.shape} {out.dtype}")
        if mask is not None and not bool((out[:, ~mask.any(dim=1)] == 0).all()):
            raise AssertionError(f"K1 {name}: all-masked rows are not zero")
        errs[name] = max_err(out, ref)
        if errs[name] > ATTN_TOL[dtype]:
            raise AssertionError(f"K1 {name}: max_abs_err {errs[name]} > "
                                 f"{ATTN_TOL[dtype]}")

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

    q, k, v = (torch.randn((3, b, 768), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    times = {}
    for label, fn in (("kernel", attention_smallseq.pairwise_token_attention),
                      ("plain",
                       attention_smallseq.pairwise_token_attention_plain)):
        call = lambda: fn(q, k, v, n_heads=12, scale=64 ** -0.5)  # noqa: E731
        times[label] = graph_ms(call)
        times[f"{label}_eager"] = cuda_ms(call)
    # the library's fused attention on the same values in its own
    # (B, H, N, Dh) layout, timed as a yardstick only
    qh, kh, vh = (bhnd(x, 12) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, scale=64 ** -0.5)
    times["library"] = graph_ms(sdpa)
    k1_bound = bound(nbytes(q, k, v, q), 4 * 3 * 3 * b * 768, torch.bfloat16)
    print("[3 K1 pairwise_attention_fwd] max_abs_err " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + " | ms at (3, 4096, 768) bf16 (device; eager with host launch "
        "cost; library = scaled_dot_product_attention): " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items())
        + f" | bound {k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']})"
        f" | {card()}")
    return {"max_abs_err": max(errs.values()), "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": times["library"],
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
            want = {"hash_encode_fwd": 2 * K2_PER_FORWARD,
                    "hash_encode_bwd": 0,
                    "pairwise_attention_fwd": 2 * K1_PER_FORWARD,
                    "pairwise_attention_bwd": 0, "vmem_attention_fwd": 0}
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
    errs = {}

    def case(name, nq, nk, b, d, h, dtype, mask=None, fused_qkv=False):
        if fused_qkv:  # strided views of one projection, as the model has
            qkv = torch.randn((nq, b, 3 * d), generator=gen, device="cuda")
            q, k, v = qkv.to(dtype).chunk(3, dim=-1)
        else:
            q = torch.randn((nq, b, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((nk, b, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((nk, b, d), generator=gen, device="cuda").to(dtype)
        do = torch.randn((nq, b, d), generator=gen, device="cuda").to(dtype)
        scale = (d // h) ** -0.5
        got = kernels.pairwise_attention_bwd(q, k, v, do, h, scale, mask)
        ref = attention_smallseq.pairwise_token_attention_bwd_plain(
            q, k, v, do, n_heads=h, scale=scale, key_mask=mask)
        rtol, atol = ATTN_BWD_TOL[dtype]
        for label, a, r in zip(("dq", "dk", "dv"), got, ref):
            if a.shape != r.shape or a.dtype != dtype:
                raise AssertionError(f"K1-bwd {name} {label}: {a.shape} "
                                     f"{a.dtype}")
            diff = (a.float() - r.float()).abs()
            if not bool((diff <= rtol * r.float().abs() + atol).all()):
                raise AssertionError(f"K1-bwd {name} {label}: max_abs_err "
                                     f"{diff.max().item()} beyond {rtol}|x| "
                                     f"+ {atol}")
            if mask is not None and not bool(
                    (a[:, ~mask.any(dim=1)] == 0).all()):
                raise AssertionError(f"K1-bwd {name} {label}: rows with no "
                                     "visible key have gradients")
            errs[f"{name} {label}"] = diff.max().item()

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

    q, k, v, do = (torch.randn((3, b, 768), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    plain = attention_smallseq.pairwise_token_attention_bwd_plain
    calls = {
        "kernel": lambda: kernels.pairwise_attention_bwd(q, k, v, do, 12,
                                                         0.125),
        "plain": lambda: plain(q, k, v, do, n_heads=12, scale=0.125)}
    times = {}
    for label, call in calls.items():
        times[label] = graph_ms(call)
        times[f"{label}_eager"] = cuda_ms(call)
    # the library's attention backward on the same values, (B, H, N, Dh),
    # eager: its graph is the autograd graph of one forward call
    qh, kh, vh = (bhnd(x, 12).requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
    doh = bhnd(do, 12)
    times["library_eager"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    k1b_bound = bound(nbytes(q, k, v, do, q, k, v), 10 * 3 * 3 * b * 768,
                      torch.bfloat16)
    worst = {k: max(v for n, v in errs.items() if n.endswith(k))
             for k in ("dq", "dk", "dv")}
    print("[5 K1-bwd pairwise_attention_bwd] max_abs_err over "
          f"{len(errs) // 3} cases: " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items())
          + " (per case: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + ") | ms at (3, 4096, 768) bf16 (device; eager with host launch "
          "cost; library = backward of scaled_dot_product_attention): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" | bound {k1b_bound['bound_ms']:.4f} ms "
          f"({k1b_bound['bound_by']}) | {card()}")
    return {"max_abs_err": max(errs.values()), "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": times["library_eager"],
            **k1b_bound}


def _hash_bwd_case(gen, n, levels, table, d, f=2, interpolation="linear",
                   table_size=None):
    coords = torch.rand((n, d), generator=gen, device="cuda")
    coords[: n // 8] = torch.randint(0, 17, (n // 8, d), generator=gen,
                                     device="cuda").float() / 16
    coords[0], coords[1] = 0.0, 1.0
    grad_out = torch.randn((n, levels * f), generator=gen, device="cuda")
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device="cuda")
    shape = (levels, table, f)
    ts = table_size or table
    got = kernels.hash_encode_bwd(coords, grad_out, res, shape, ts,
                                  interpolation == "linear")
    again = kernels.hash_encode_bwd(coords, grad_out, res, shape, ts,
                                    interpolation == "linear")
    kw = dict(interpolation=interpolation, table_size=table_size)
    ref = hash_encoding.hash_encode_bwd_plain(coords, grad_out, res, shape,
                                              **kw)
    abs_sum = hash_encoding.hash_encode_bwd_plain(coords, grad_out.abs(), res,
                                                  shape, **kw)
    if got.shape != shape or not bool(got.isfinite().all()):
        raise AssertionError(f"K2-bwd output {tuple(got.shape)}")
    diff = (got - ref).abs()
    if not bool((diff <= HASH_BWD_TOL * abs_sum).all()):
        raise AssertionError(f"K2-bwd beyond {HASH_BWD_TOL} of sum|terms|: "
                             f"max_abs_err {diff.max().item()}")
    return diff.max().item(), (got - again).abs().max().item()


def phase_hash_bwd(gen) -> dict:
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
    errs, repeat = {}, {}
    for name, kw in cases.items():
        errs[name], repeat[name] = _hash_bwd_case(gen, n, **kw)

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
        calls = {
            "kernel": lambda c, g: kernels.hash_encode_bwd(
                c, g, res, shape, hcfg.hash_table_size, True),
            "plain": lambda c, g: hash_encoding.hash_encode_bwd_plain(
                c, g, res, shape)}
        for label, fn in calls.items():
            inputs = itertools.cycle(pool)
            call = lambda: fn(*next(inputs))  # noqa: E731
            times[f"{name}_{label}"] = graph_ms(call)
            times[f"{name}_{label}_eager"] = cuda_ms(call)
    print(f"[6 K2-bwd hash_encode_bwd] max_abs_err {max(errs.values()):.3g} "
          f"(tol {HASH_BWD_TOL} of each row's sum |terms|) over {len(cases)} "
          "cases: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " | run to run: " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in repeat.items())
          + " | ms at N=4096 (device; eager with host launch cost; each "
          "includes zeroing the table gradient): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" | spatial bound {k2b_bound['bound_ms']:.4f} ms "
          f"({k2b_bound['bound_by']}) | {card()}")
    return {"max_abs_err": max(errs.values()), "ms": times["spatial_kernel"],
            "plain_ms": times["spatial_plain"], "library_ms": None,
            **k2b_bound}


def _run_steps(trainer, state, batches, seed):
    """Train steps over ``batches`` from a generator seeded with ``seed``;
    returns per-step (loss, grad_norm) as floats."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for batch in batches:
        state, m = trainer.train_step(state, batch, g)
        out.append((m["loss/total"].item(), m["grad_norm"].item()))
    return out


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
    want = {"hash_encode_fwd": K2_PER_FORWARD * (TRAIN_STEPS + 2),
            "hash_encode_bwd": K2_PER_FORWARD * TRAIN_STEPS,
            "pairwise_attention_fwd": K1_PER_FORWARD * (TRAIN_STEPS + 2),
            "pairwise_attention_bwd": K1_PER_FORWARD * TRAIN_STEPS,
            "vmem_attention_fwd": 0}
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps and 2 eval "
                             f"batches {launches} != {want}")
    for name, v in {**fit_metrics, **val}.items():
        if not math.isfinite(v):
            raise AssertionError(f"{name} = {v}")

    # kernel path vs plain path: 3 steps each from the same parameters, a
    # fresh optimizer and the same masks (one seed)
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
    lrs = [st.optimizer.learning_rate(i) for i in range(TRAIN_STEPS)]
    param_tol = 3 * sum(lrs)
    rel = {k: max(abs(a[i] - b[i]) / abs(b[i]) for a, b in
                  zip(runs["kernel"], runs["plain"]))
           for i, k in enumerate(("loss", "grad_norm"))}
    param_err = max((params["kernel"][n] - params["plain"][n]).abs().max()
                    .item() for n in params["kernel"])
    if any(rel[k] > TRAIN_TOL[k] for k in TRAIN_TOL) or param_err > param_tol:
        raise AssertionError(f"kernel vs plain train path: {runs}, params "
                             f"{param_err} (tol {param_tol})")

    # the loss falls on one repeated batch at a constant learning rate
    model.load_state_dict(start)
    fast = dataclasses.replace(cfg.optimizer, schedule="constant",
                               learning_rate=1e-3)
    st = TrainState(model, create_optimizer(model.parameters(), fast))
    falls = _run_steps(trainer, st, batches[:1] * LOSS_FALL_STEPS, seed=2)
    if not falls[-1][0] < falls[0][0]:
        raise AssertionError(f"loss did not fall: {falls}")

    # step time, eager, with the kernels and with the plain versions
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    for label in ("kernel", "plain", "kernel_again", "plain_again"):
        g = torch.Generator(device="cuda").manual_seed(3)
        with (plain_versions() if label.startswith("plain")
              else contextlib.nullcontext()):
            timing[label] = cuda_ms(
                lambda: trainer.train_step(st, batches[0], g), iters=10,
                warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = min(timing["kernel"], timing["kernel_again"])
    plain_ms = min(timing["plain"], timing["plain_again"])
    print(f"[7 train slice A-stack] B={TRAIN_BATCH}, masking on, fit "
          f"{TRAIN_STEPS} steps + evaluate 2 batches: launches {launches} | "
          f"fit loss {fit_metrics['loss/total']:.4f}, val loss "
          f"{val['loss/total']:.4f} | kernel vs plain path over "
          f"{TRAIN_STEPS} steps (loss, grad_norm): kernel {runs['kernel']}, "
          f"plain {runs['plain']}, rel diff {rel} (tol {TRAIN_TOL}), params "
          f"max_abs {param_err:.3g} (tol 3*sum(lr) = {param_tol:.3g}) | loss "
          f"on one batch at lr 1e-3: {falls[0][0]:.4f} -> "
          f"{falls[-1][0]:.4f} in {LOSS_FALL_STEPS} steps | step ms eager "
          f"(CUDA events over 10 steps, order kernel, plain, kernel, plain): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
          + f" | {TRAIN_BATCH / step_ms * 1e3:.0f} obs/s with the kernels, "
          f"{TRAIN_BATCH / plain_ms * 1e3:.0f} with the plain versions | "
          f"peak mem {peak:.2f} GiB | {card()}")
    return {"launches": launches}


def _vmem_inputs(gen, b, h, nq, nk, dqk, dv, dtype, mask=False):
    q = torch.randn((b, h, nq, dqk), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, nk, dqk), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, nk, dv), generator=gen, device="cuda").to(dtype)
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=gen, device="cuda") > 0.3
        key_mask[0] = False  # a row that sees no key at all
    return q, k, v, key_mask


def phase_vmem(gen) -> dict:
    errs = {}
    cases = {  # name: (B, H, Nq, Nk, Dqk, Dv, key mask)
        "MLA site B=512 576x576 Dqk48 Dv32": (MM_BATCH, 8, 576, 576, 48, 32,
                                               False),
        "cross site B=512 16x576 Dh64": (MM_BATCH, 8, 16, 576, 64, 64, False),
        "ragged 100x260 Dqk48 Dv80 masked": (4, 3, 100, 260, 48, 80, True),
        "Nk=1024 Dh128 masked": (8, 4, 64, 1024, 128, 128, True),
    }
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        for name, (b, h, nq, nk, dqk, dv, mask) in cases.items():
            q, k, v, key_mask = _vmem_inputs(gen, b, h, nq, nk, dqk, dv,
                                             dtype, mask)
            kw = dict(scale=dqk ** -0.5, key_mask=key_mask)
            out = attention_vmem.vmem_attention(q, k, v, **kw)
            ref = attention_vmem.vmem_attention_plain(q, k, v, **kw)
            if out.shape != (b, h, nq, dv) or out.dtype != dtype:
                raise AssertionError(f"K3 {name}: {out.shape} {out.dtype}")
            if mask and not bool((out[0] == 0).all()):
                raise AssertionError(f"K3 {name}: the all-masked row is not 0")
            err = max_err(out, ref)
            errs[f"{name} {tag}"] = err
            if err > VMEM_TOL[dtype]:
                raise AssertionError(f"K3 {name} {tag}: max_abs_err {err} > "
                                     f"{VMEM_TOL[dtype]}")
            del q, k, v, out, ref

    # the slice's two sites at B=512 in bf16: kernel, plain, the library's
    # fused attention on the same tensors (a yardstick only), and the bound
    sites = {}
    for name, (nq, dqk, dv) in {"mla": (576, 48, 32),
                                "cross": (16, 64, 64)}.items():
        q, k, v, _ = _vmem_inputs(gen, MM_BATCH, 8, nq, VISION_PATCHES, dqk,
                                  dv, torch.bfloat16)
        sc = dqk ** -0.5
        t = {
            "ms": cuda_ms(lambda: kernels.vmem_attention_fwd(q, k, v, sc),
                          iters=10, warmup=2),
            "plain_ms": cuda_ms(lambda: attention_vmem.vmem_attention_plain(
                q, k, v, scale=sc), iters=5, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=sc), iters=10, warmup=2),
        }
        flops = 2 * MM_BATCH * 8 * nq * VISION_PATCHES * (dqk + dv)
        t.update(bound(nbytes(q, k, v) + MM_BATCH * 8 * nq * dv * 2, flops,
                       torch.bfloat16))
        t["tflops"] = flops / t["ms"] / 1e9
        sites[name] = t
        del q, k, v
    print("[8 K3 vmem_attention_fwd] max_abs_err " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {dict((str(k).split('.')[-1], v) for k, v in VMEM_TOL.items())})"
        + " | ms at B=512 bf16 (device, CUDA events; library = "
        "scaled_dot_product_attention): " + ", ".join(
            f"{n} kernel {t['ms']:.4f} ({t['tflops']:.2f} TFLOP/s), plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']})" for n, t in sites.items())
        + f" | {card()}")
    per_forward = {key: sum(t[key] for t in sites.values())
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_bytes = sum(t["bound_ms"] for t in sites.values()
                   if t["bound_by"] == "bytes")
    return {"max_abs_err": max(errs.values()), **per_forward,
            "bound_by": "bytes" if 2 * by_bytes >= per_forward["bound_ms"]
            else "operations", "sites": sites}


def multimodal_config() -> DeepEarthConfig:
    """The configuration of tools/bench_multimodal.py, bf16 compute."""
    cfg = DeepEarthConfig(
        hidden_dim=512, n_heads=8, n_layers=4,
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


def make_mm_batch(gen, n):
    """One request: n observations, each with a place and time, a species,
    576 V-JEPA2 patch embeddings and one language embedding."""
    return {
        "xyzt": torch.rand((n, 4), generator=gen, device="cuda"),
        "modalities": {
            "species": torch.randint(0, 232, (n,), generator=gen,
                                     device="cuda"),
            "vision": torch.randn((n, VISION_PATCHES, 1408), generator=gen,
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
        (kernel_rows if "CUDA" in str(e.device_type) else op_rows).append(row)
    return (sorted(kernel_rows, key=lambda r: -r[1]),
            sorted(op_rows, key=lambda r: -r[1]))


def phase_multimodal(gen) -> dict:
    cfg = multimodal_config()
    model = DeepEarthModel(cfg, generator=gen, device="cuda",
                           native_seq_lens={"vision": VISION_PATCHES}).eval()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [make_mm_batch(gen, n) for n in MM_REQUEST_SIZES]
    want = {"hash_encode_fwd": 2 * 2, "hash_encode_bwd": 0,
            "pairwise_attention_fwd": 0, "pairwise_attention_bwd": 0,
            "vmem_attention_fwd": 2 * K3_PER_FORWARD}

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
          f"{K3_PER_FORWARD} K2 2 K1 0, no plain version reached | vs plain "
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
    print(f"[9 kernels by device time, B={MM_BATCH} forward, ms per forward "
          "(launches)] " + "; ".join(
              f"{name[:60]} {ms:.4f} ({cnt:.0f})"
              for name, ms, cnt in breakdown[:25])
          + f" | total {sum(r[1] for r in breakdown):.3f} ms in "
          f"{sum(r[2] for r in breakdown):.0f} launches")
    print(f"[9 torch ops by the device time of their kernels, B={MM_BATCH} "
          "forward, ms per forward (calls)] " + "; ".join(
              f"{name} {ms:.4f} ({cnt:.0f})" for name, ms, cnt in by_op[:20]))
    return {"launches": launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_build()
    k2 = phase_hash(gen)
    k1 = phase_attention(gen)
    sl = phase_slice(gen)
    k1b = phase_attention_bwd(gen)
    k2b = phase_hash_bwd(gen)
    tr = phase_train(gen)
    k3 = phase_vmem(gen)
    mm = phase_multimodal(gen)
    report = {"kernels": [
        {"name": "hash_encode_fwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/hash_encode.cu",
         "replaces": "deepearth_tpu/ops/hash_encoding.py:113",
         "launches": sl["launches"]["hash_encode_fwd"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
        {"name": "pairwise_attention_fwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/pairwise_attention.cu",
         "replaces": "deepearth_tpu/ops/attention_smallseq.py:156",
         "launches": sl["launches"]["pairwise_attention_fwd"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "pairwise_attention_bwd", "route": "cuda",
         "source": "deepearth_tpu_torch/kernels/csrc/pairwise_attention_bwd.cu",
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
         "source": "deepearth_tpu_torch/kernels/csrc/attention_vmem.cu",
         "replaces": "deepearth_tpu/ops/attention_vmem.py:64",
         "launches": mm["launches"]["vmem_attention_fwd"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"]},
    ]}
    # each kernel's bound and library call; K3's numbers are per forward,
    # its MLA and cross sites at B=512 added
    for entry, phase in zip(report["kernels"], (k2, k1, k1b, k2b, k3)):
        entry.update({key: phase[key] for key in
                      ("bound_ms", "bound_by", "library_ms")})
    for k in report["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    print(json.dumps(report))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
