"""Decoding CLI of the port, the counterpart of the JAX package's
``scripts/generate_cli.py``: a converted DeepSeek checkpoint (the directory
``cli.convert_checkpoint`` or the JAX script writes) decodes a prompt over
the compressed MLA cache (``models.generation.generate``).

Usage:
    python -m deepearth_tpu_torch.cli.generate converted_dir \\
        --prompt "live oak" [--tokenizer hf_name_or_path] \\
        [--max-new-tokens 64] [--temperature 0.8] [--top-k 40] [--seed 0] \\
        [--device cpu]

Without ``--tokenizer`` the prompt is hashed to stable token ids (the
language service's ``HashEmbedder``, the air-gapped default) and the output
printed as ids; with an HF tokenizer (``transformers``, imported only
then), text in and text out. Sampling draws from a ``torch.Generator``
seeded with ``--seed``; greedy decoding (temperature 0, the default) gives
the JAX script's tokens.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..models.generation import generate
from ..serving.language_server import HashEmbedder
from .convert_checkpoint import causal_lm, load_converted


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="decode from a converted DeepSeek checkpoint")
    ap.add_argument("converted_dir",
                    help="output of cli.convert_checkpoint (or the JAX "
                         "script)")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--tokenizer", help="HF tokenizer name/path (optional)")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[list] = None) -> List[int]:
    """Decode and print; returns the generated token ids."""
    args = build_parser().parse_args(argv)
    params, cfg, vocab = load_converted(args.converted_dir)
    model = causal_lm(params, cfg, vocab, args.device)
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer)
        ids = tok(args.prompt)["input_ids"]
    else:
        ids = [t % vocab for t in HashEmbedder().tokenize(args.prompt)] or [0]
    with torch.no_grad():
        out = generate(
            model, torch.tensor([ids], dtype=torch.long, device=args.device),
            args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k or None,
            generator=torch.Generator(device=args.device).manual_seed(
                args.seed))
    toks = out[0].tolist()
    print(tok.decode(toks) if tok is not None else " ".join(map(str, toks)))
    return toks


if __name__ == "__main__":
    main()
