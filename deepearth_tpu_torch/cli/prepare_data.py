"""Data preparation CLI of the port: parquet embeddings -> mmap store, the
counterpart of the JAX package's ``scripts/prepare_data.py`` (reference:
dashboard/prepare_embeddings.py CLI).

Converts per-observation embedding columns from a parquet file into the
binary blob + flat index layout that ``MMapEmbeddingLoader`` serves (the
JAX package's loader reads the same files), with a verification pass.

Usage:
    python -m deepearth_tpu_torch.cli.prepare_data --input embeddings.parquet \\
        --id-column gbif_id --embedding-column embedding \\
        --shape 576 1408 --output /data/vision --dtype float16

:func:`write_store` is the conversion itself, over any iterator of
``(ids, embeddings)`` chunks.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterable, Sequence, Tuple

import numpy as np

from ..data import MMapEmbeddingLoader, MMapEmbeddingWriter


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="parquet -> mmap embedding store")
    ap.add_argument("--input", required=True, nargs="+",
                    help="parquet file(s), converted in order")
    ap.add_argument("--append", action="store_true",
                    help="extend an existing store instead of overwriting "
                         "(chunked conversion with bounded staging disk)")
    ap.add_argument("--id-column", default="gbif_id")
    ap.add_argument("--embedding-column", default="embedding")
    ap.add_argument("--shape", type=int, nargs="+", required=True,
                    help="per-embedding shape, e.g. 576 1408")
    ap.add_argument("--output", required=True, help="store path prefix")
    ap.add_argument("--dtype", default="float16", choices=["float16", "float32"])
    ap.add_argument("--batch-rows", type=int, default=64)
    return ap


def parquet_chunks(paths: Sequence[str], id_column: str,
                   embedding_column: str, batch_rows: int
                   ) -> Iterable[Tuple[list, object]]:
    """``(ids, embeddings)`` chunks of ``batch_rows`` rows from parquet
    files, in order."""
    import pyarrow.parquet as pq

    for path in paths:
        pf = pq.ParquetFile(path)
        for batch in pf.iter_batches(
            batch_size=batch_rows, columns=[id_column, embedding_column],
        ):
            ids = batch.column(id_column).to_pylist()
            col = batch.column(embedding_column)
            try:
                # fast path for (fixed-size-)list columns: flatten to one
                # contiguous numpy buffer instead of per-row pylists
                if hasattr(col, "combine_chunks"):
                    col = col.combine_chunks()
                embs = (
                    col.flatten()
                    .to_numpy(zero_copy_only=False)
                    .reshape(len(ids), -1)
                )
            except Exception:
                embs = col.to_pylist()
            yield ids, embs


def write_store(output: str, shape: Sequence[int], dtype: str,
                chunks: Iterable[Tuple[Sequence[int], object]],
                append: bool = False) -> int:
    """Write every ``(ids, embeddings)`` chunk into the store at
    ``output``, then check a sample of rows reads back. Returns the number
    of embeddings written."""
    n_written = 0
    with MMapEmbeddingWriter(output, shape, dtype, append=append) as w:
        for ids, embs in chunks:
            for oid, emb in zip(ids, embs):
                w.add(int(oid), np.asarray(emb, np.float32).reshape(shape))
                n_written += 1
            if n_written % 1000 < len(ids):
                print(f"  {n_written} embeddings written...", flush=True)

    loader = MMapEmbeddingLoader(output)
    # verification pass (reference: prepare_embeddings.py:290)
    rng = np.random.default_rng(0)
    for i in rng.choice(len(loader), min(8, len(loader)), replace=False):
        oid = int(loader.ids[i])
        if loader.get(oid) is None:
            raise RuntimeError(f"verification failed for {oid}")
    return n_written


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    t0 = time.time()
    n_written = write_store(
        args.output, args.shape, args.dtype,
        parquet_chunks(args.input, args.id_column, args.embedding_column,
                       args.batch_rows),
        append=args.append)
    size_gb = os.path.getsize(args.output + ".bin") / 1e9
    print(
        f"done: {n_written} embeddings, {size_gb:.2f} GB, "
        f"{time.time() - t0:.1f}s → {args.output}.bin"
    )


if __name__ == "__main__":
    main()
