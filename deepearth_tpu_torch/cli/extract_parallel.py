"""Sharded embedding-extraction CLI of the port, the counterpart of the JAX
package's ``scripts/extract_parallel.py`` (reference:
encoders/vision/run_parallel_extraction.sh: split the item list across
workers, one extractor process per shard, merge the chunk outputs).

Usage:
    # worker k of N (run N of these, one per host or card):
    python -m deepearth_tpu_torch.cli.extract_parallel extract \\
        --items items.txt --out-dir /data/chunks --shard-id 0 \\
        --num-shards 4 --extractor stub --batch-size 16

    # then merge the chunk stores into one mmap store:
    python -m deepearth_tpu_torch.cli.extract_parallel merge \\
        --out-dir /data/chunks --store /data/vision_store

Items file: one item per line as ``<obs_id>\\t<payload>`` (payload = image
path / text, handed to the extractor). Each worker writes
``chunk_<k>.npz``; merge builds a single ``MMapEmbeddingWriter`` store. The
same arguments give the same files as the JAX package's script; the
backbones of ``--extractor vjepa2`` / ``language`` run on ``--device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from ..data.extractors import (
    LanguageModelExtractor,
    StubExtractor,
    VJEPA2Extractor,
)
from ..data.mmap_store import MMapEmbeddingLoader, MMapEmbeddingWriter


def shard_items(items, shard_id: int, num_shards: int):
    """Contiguous-stride shard (the policy of DistributedSampler and of the
    JAX package's ``parallel/mesh.py`` process_local_batch_indices)."""
    return items[shard_id::num_shards]


def make_extractor(name: str, dim: int, device="cuda"):
    if name == "stub":
        return StubExtractor(dim=dim)
    if name == "vjepa2":
        return VJEPA2Extractor(device=device)
    if name == "language":
        return LanguageModelExtractor(device=device)
    raise ValueError(f"unknown extractor {name!r}")


def cmd_extract(args):
    with open(args.items) as f:
        items = [ln.rstrip("\n").split("\t", 1) for ln in f if ln.strip()]
    mine = shard_items(items, args.shard_id, args.num_shards)
    print(f"[shard {args.shard_id}/{args.num_shards}] {len(mine)} items",
          file=sys.stderr)
    extractor = make_extractor(args.extractor, args.dim, args.device)

    ids, embs = [], []
    for i in range(0, len(mine), args.batch_size):
        chunk = mine[i: i + args.batch_size]
        payloads = [c[1] for c in chunk]
        out = np.asarray(extractor.extract_native_embeddings(payloads))
        embs.append(out.astype(np.float16))
        ids.extend(int(c[0]) for c in chunk)
        print(f"[shard {args.shard_id}] "
              f"{min(i + args.batch_size, len(mine))}/{len(mine)}",
              file=sys.stderr)
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, f"chunk_{args.shard_id}.npz")
    np.savez(
        out_path,
        ids=np.asarray(ids, np.int64),
        embeddings=np.concatenate(embs) if embs else np.zeros((0, args.dim)),
    )
    print(f"wrote {out_path}", file=sys.stderr)


def cmd_merge(args):
    chunks = sorted(
        f for f in os.listdir(args.out_dir)
        if f.startswith("chunk_") and f.endswith(".npz")
    )
    if not chunks:
        raise SystemExit(f"no chunk_*.npz in {args.out_dir}")
    with np.load(os.path.join(args.out_dir, chunks[0])) as first:
        shape = first["embeddings"].shape[1:]
    n_total = 0
    with MMapEmbeddingWriter(args.store, shape, args.dtype) as w:
        for c in chunks:
            with np.load(os.path.join(args.out_dir, c)) as d:
                for oid, emb in zip(d["ids"], d["embeddings"]):
                    w.add(int(oid), emb)
                    n_total += 1
    loader = MMapEmbeddingLoader(args.store)
    if len(loader) != n_total:
        raise RuntimeError(f"the store holds {len(loader)} embeddings, "
                           f"{n_total} were merged")
    print(f"merged {len(chunks)} chunks, {n_total} embeddings → "
          f"{args.store}", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("extract")
    e.add_argument("--items", required=True)
    e.add_argument("--out-dir", required=True)
    e.add_argument("--shard-id", type=int, required=True)
    e.add_argument("--num-shards", type=int, required=True)
    e.add_argument("--extractor", default="stub",
                   choices=["stub", "vjepa2", "language"])
    e.add_argument("--batch-size", type=int, default=16)
    e.add_argument("--dim", type=int, default=64)
    e.add_argument("--device", default="cuda",
                   help="where a backbone runs: cuda (default) or cpu")
    e.set_defaults(fn=cmd_extract)
    m = sub.add_parser("merge")
    m.add_argument("--out-dir", required=True)
    m.add_argument("--store", required=True)
    m.add_argument("--dtype", default="float16")
    m.set_defaults(fn=cmd_merge)
    return p


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
