"""Checkpoint conversion CLI of the port, the counterpart of the JAX
package's ``scripts/convert_checkpoint.py``: an HF DeepSeek checkpoint
(a directory of ``.safetensors`` or torch files with its ``config.json``,
or a bare torch state file with ``--config``) becomes a directory of
``params.msgpack`` (flax's ``msgpack_serialize`` layout, written without
flax) and ``config.json`` (``{"block_config", "vocab_size"}``), the layout
the JAX script writes, so that either package's CLIs read the other's.

Usage:
    python -m deepearth_tpu_torch.cli.convert_checkpoint /path/to/hf_ckpt \\
        out_dir [--config config.json] [--verify] [--device cpu]

``--verify`` runs the port's ``DeepSeekForCausalLM`` on the converted
parameters (the card unless ``--device cpu``). The parameters stay float32,
as the JAX script leaves them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import (
    DeepSeekBlockConfig,
    MLAConfig,
    MoEConfig,
    RopeScalingConfig,
)
from ..convert import _leaves, load_flax_params
from ..models.deepseek import DeepSeekForCausalLM
from ..models.hf_convert import load_hf_checkpoint
from ..utils.checkpoint_files import read_msgpack_tree, write_msgpack_tree


def save_converted(out_dir: str, params: Dict[str, Any],
                   cfg: DeepSeekBlockConfig, vocab_size: int) -> None:
    """``params.msgpack`` and ``config.json``, as the JAX script's
    ``save_converted`` writes them."""
    os.makedirs(out_dir, exist_ok=True)
    write_msgpack_tree(os.path.join(out_dir, "params.msgpack"), params)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"block_config": dataclasses.asdict(cfg),
                   "vocab_size": vocab_size}, f, indent=2, default=str)


def load_converted(out_dir: str
                   ) -> Tuple[Dict[str, Any], DeepSeekBlockConfig, int]:
    """(params, DeepSeekBlockConfig, vocab_size) of a converted directory
    written by either package."""
    params = read_msgpack_tree(os.path.join(out_dir, "params.msgpack"))
    with open(os.path.join(out_dir, "config.json")) as f:
        meta = json.load(f)
    bc = dict(meta["block_config"])
    mla = dict(bc.pop("mla"))
    scaling = mla.pop("rope_scaling", None)
    if isinstance(scaling, dict):
        mla["rope_scaling"] = RopeScalingConfig(**scaling)
    moe = bc.pop("moe", None)
    cfg = DeepSeekBlockConfig(
        mla=MLAConfig(**mla),
        moe=MoEConfig(**moe) if isinstance(moe, dict) else None, **bc)
    return params, cfg, int(meta["vocab_size"])


def causal_lm(params: Dict[str, Any], cfg: DeepSeekBlockConfig,
              vocab_size: int, device="cuda") -> DeepSeekForCausalLM:
    """The port's ``DeepSeekForCausalLM`` on ``device`` holding converted
    parameters (an ``lm_head`` where the tree has one), in float32."""
    model = DeepSeekForCausalLM(
        cfg, vocab_size,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device, tie_embeddings="lm_head" not in params)
    load_flax_params(model, params)
    return model.eval()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="convert an HF DeepSeek checkpoint to flax-layout params")
    ap.add_argument("checkpoint",
                    help="HF checkpoint dir (or torch state file)")
    ap.add_argument("out_dir")
    ap.add_argument("--config",
                    help="config.json path when checkpoint is a bare state "
                         "file")
    ap.add_argument("--verify", action="store_true",
                    help="run a forward through the converted params")
    ap.add_argument("--device", default="cuda",
                    help="where --verify runs: cuda (the default) or cpu")
    return ap


def main(argv: Optional[list] = None
         ) -> Tuple[Dict[str, Any], DeepSeekBlockConfig, int]:
    """Convert, save, and (``--verify``) run a forward. Returns the
    converted (params, block config, vocab size)."""
    args = build_parser().parse_args(argv)
    hf_cfg = None
    if args.config:
        with open(args.config) as f:
            hf_cfg = json.load(f)
    params, cfg, vocab = load_hf_checkpoint(args.checkpoint, hf_cfg)
    save_converted(args.out_dir, params, cfg, vocab)
    n = sum(v.size for _, v in _leaves(params))
    print(f"converted {n / 1e6:.1f}M params → {args.out_dir}")
    if args.verify:
        p2, cfg2, vocab2 = load_converted(args.out_dir)
        model = causal_lm(p2, cfg2, vocab2, args.device)
        with torch.no_grad():
            logits = model(torch.zeros((1, 4), dtype=torch.long,
                                       device=args.device))
        if tuple(logits.shape) != (1, 4, vocab2):
            raise AssertionError(f"logits {tuple(logits.shape)}")
        print(f"verify OK: logits {tuple(logits.shape)}, finite="
              f"{bool(torch.isfinite(logits).all())}")
    return params, cfg, vocab


if __name__ == "__main__":
    main()
