"""Observation dataset + unified cache — the data engine (L1); the port's
copy of ``deepearth_tpu/data/observations.py`` (numpy, with pandas imported
only by the dataset class).

Replaces the reference's dashboard data plumbing
(reference: dashboard/huggingface_data_loader.py:30-406,
dashboard/data_cache.py:41-582, dashboard/services/training_data.py:22-80,
dashboard/dataset_config.json) with one parquet/HF-backed dataset class and a
unified cache that assembles model-ready batches from the mmap stores.

V-JEPA2 embedding layout helpers implement the documented reshape recipe:
flat 6,488,064 floats → (8, 24, 24, 1408) = temporal × H × W × channels.
"""

from __future__ import annotations

import json
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger
from .mmap_store import MMapEmbeddingLoader

logger = get_logger("Data")

# V-JEPA2 grid (reference: dashboard/dataset_config.json reshape recipe)
VJEPA2_SHAPE = (8, 24, 24, 1408)
VJEPA2_FLAT = int(np.prod(VJEPA2_SHAPE))
LANGUAGE_DIM = 7168


def reshape_vision_embedding(flat: np.ndarray) -> np.ndarray:
    """(6488064,) → (8, 24, 24, 1408)."""
    return np.asarray(flat).reshape(VJEPA2_SHAPE)


def temporal_frame(emb: np.ndarray, t: int) -> np.ndarray:
    """(8,24,24,1408) → (24,24,1408) single temporal frame
    (reference: huggingface_data_loader.py reshape helpers)."""
    return emb[t]


def spatial_patch(emb: np.ndarray, y: int, x: int) -> np.ndarray:
    """(8,24,24,1408) → (8,1408) one spatial patch across time."""
    return emb[:, y, x]


def image_level_mean(emb: np.ndarray) -> np.ndarray:
    """(8,24,24,1408) → (1408,) pooled image embedding."""
    return emb.reshape(-1, emb.shape[-1]).mean(axis=0)


def spatial_attention_map(emb: np.ndarray) -> np.ndarray:
    """L2-norm saliency over the (24,24) grid, mean over time
    (reference: data_cache.py spatial attention maps)."""
    return np.linalg.norm(emb, axis=-1).mean(axis=0)


@dataclass
class DatasetConfig:
    """Dataset runtime config (reference: dashboard/dataset_config.json)."""

    name: str = "central-florida-native-plants"
    observations_path: Optional[str] = None  # parquet file
    hf_dataset: Optional[str] = None  # e.g. "deepearth/central-florida-native-plants"
    vision_store_path: Optional[str] = None  # mmap store prefix
    language_store_path: Optional[str] = None
    bbox: Tuple[float, float, float, float] = (28.03, -81.93, 28.98, -80.90)
    year_range: Tuple[int, int] = (2010, 2025)
    cache_size: int = 256

    @classmethod
    def from_json(cls, path: str) -> "DatasetConfig":
        with open(path) as f:
            d = json.load(f)
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "observations_path": self.observations_path,
                    "hf_dataset": self.hf_dataset,
                    "vision_store_path": self.vision_store_path,
                    "language_store_path": self.language_store_path,
                    "bbox": list(self.bbox),
                    "year_range": list(self.year_range),
                    "cache_size": self.cache_size,
                },
                f,
                indent=2,
            )


class ObservationDataset:
    """Tabular observation access from parquet or the HF hub
    (reference: dashboard/huggingface_data_loader.py:30-406).

    Required columns: gbif_id, species (string or int), latitude, longitude;
    optional: altitude, year/month/day or timestamp.
    """

    def __init__(self, table, species_vocab: Optional[List[str]] = None):
        import pandas as pd

        self.df: "pd.DataFrame" = table.reset_index(drop=True)
        # Reference-schema adaptation (dashboard/dataset_config.json
        # data_schema.observations): the published parquet names the species
        # column ``taxon_name`` and carries the 7168-d DeepSeek-V3 language
        # embedding per row in ``language_embedding``; accept that schema
        # directly.
        if "species" not in self.df and "taxon_name" in self.df:
            self.df["species"] = self.df["taxon_name"]
        import pandas.api.types as ptypes

        is_numeric = ptypes.is_numeric_dtype(self.df["species"])
        if species_vocab is None:
            if is_numeric:
                species_vocab = [
                    str(s) for s in range(int(self.df["species"].max()) + 1)
                ]
            else:
                species_vocab = sorted(self.df["species"].unique().tolist())
        self.species_vocab = species_vocab
        self._species_to_idx = {s: i for i, s in enumerate(species_vocab)}
        if is_numeric:
            self.df["species_idx"] = self.df["species"].astype(int)
        else:
            self.df["species_idx"] = self.df["species"].map(self._species_to_idx)
        self._id_index = {
            int(g): i for i, g in enumerate(self.df["gbif_id"].to_numpy())
        }

    # -- constructors --------------------------------------------------------- #

    @classmethod
    def from_parquet(cls, path: str) -> "ObservationDataset":
        import pandas as pd

        return cls(pd.read_parquet(path))

    @classmethod
    def from_huggingface(
        cls, name: str, split: str = "train"
    ) -> "ObservationDataset":
        """Load from the HF hub (requires network; reference dataset:
        deepearth/central-florida-native-plants)."""
        import datasets

        ds = datasets.load_dataset(name, split=split)
        return cls(ds.to_pandas())

    @classmethod
    def from_arrays(cls, **columns) -> "ObservationDataset":
        import pandas as pd

        return cls(pd.DataFrame(columns))

    # -- access --------------------------------------------------------------- #

    def __len__(self) -> int:
        return len(self.df)

    @property
    def n_species(self) -> int:
        return len(self.species_vocab)

    def row_for_id(self, gbif_id: int) -> Optional[int]:
        return self._id_index.get(int(gbif_id))

    def columns(self) -> Dict[str, np.ndarray]:
        out = {
            "gbif_id": self.df["gbif_id"].to_numpy(np.int64),
            "lat": self.df["latitude"].to_numpy(np.float64),
            "lon": self.df["longitude"].to_numpy(np.float64),
            "species": self.df["species_idx"].to_numpy(np.int32),
        }
        if "altitude" in self.df:
            out["alt"] = self.df["altitude"].to_numpy(np.float64)
        if "year" in self.df:
            out["year"] = self.df["year"].to_numpy(np.int32)
        return out

    def normalized_xyzt(
        self,
        rows: Optional[np.ndarray] = None,
        bbox: Optional[Tuple[float, float, float, float]] = None,
        year_range: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """(N, 4) normalized coordinates from lat/lon/alt/time."""
        df = self.df if rows is None else self.df.iloc[rows]
        lat = df["latitude"].to_numpy(np.float64)
        lon = df["longitude"].to_numpy(np.float64)
        alt = (
            df["altitude"].to_numpy(np.float64)
            if "altitude" in df
            else np.zeros(len(df))
        )
        if bbox is None:
            bbox = (lat.min(), lon.min(), lat.max(), lon.max())
        s, w, n, e = bbox
        x = np.clip((lat - s) / max(n - s, 1e-9), 0, 1)
        y = np.clip((lon - w) / max(e - w, 1e-9), 0, 1)
        z = np.clip(alt / 1000.0, 0, 1)
        if "year" in df:
            yr = df["year"].to_numpy(np.float64)
            frac = df["month"].to_numpy(np.float64) / 12.0 if "month" in df else 0.0
            yr = yr + frac
            y0, y1 = year_range or (yr.min(), yr.max() + 1)
            t = np.clip((yr - y0) / max(y1 - y0, 1e-9), 0, 1)
        else:
            t = np.full(len(df), 0.5)
        return np.stack([x, y, z, t], axis=-1).astype(np.float32)


def _process_local_batch_indices(n_total: int) -> np.ndarray:
    """DistributedSampler equivalent: this process's contiguous shard of
    ``n_total`` indices, by its ``torch.distributed`` rank (the whole range
    outside a process group)."""
    import torch.distributed as dist

    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_available() and dist.is_initialized()
                   else (0, 1))
    per = int(math.ceil(n_total / world))
    start = rank * per
    return np.arange(start, min(start + per, n_total))


class _LRU(OrderedDict):
    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def put(self, k, v):
        if k in self:
            self.move_to_end(k)
        self[k] = v
        while len(self) > self.maxsize:
            self.popitem(last=False)


class UnifiedDataCache:
    """Observations + embedding stores + size-bounded caches + batch assembly
    (reference: dashboard/data_cache.py:41-582)."""

    def __init__(
        self,
        dataset: ObservationDataset,
        cfg: Optional[DatasetConfig] = None,
        vision_loader: Optional[MMapEmbeddingLoader] = None,
        language_loader: Optional[MMapEmbeddingLoader] = None,
    ):
        self.dataset = dataset
        self.cfg = cfg or DatasetConfig()
        self.vision_loader = vision_loader or (
            MMapEmbeddingLoader(self.cfg.vision_store_path)
            if self.cfg.vision_store_path
            else None
        )
        self.language_loader = language_loader or (
            MMapEmbeddingLoader(self.cfg.language_store_path)
            if self.cfg.language_store_path
            else None
        )
        self._vision_cache = _LRU(self.cfg.cache_size)
        self._language_cache = _LRU(self.cfg.cache_size)
        self._lang_mat: Optional[np.ndarray] = None  # lazy, see below
        self._lang_has: Optional[np.ndarray] = None

    # Stacked fp16 copy of the parquet language column. The per-row
    # ``col.iloc[r]`` loop is 24.25 of the ~30 ms B=256 batch assembly at
    # soak scale (tools/profile_batch_assembly.py) — one fancy-index on a
    # prebuilt matrix is ~100x cheaper. 33,665 x 7168 fp16 = 483 MB host
    # RAM; skipped above ``max_bytes`` (then the loop path runs as before).
    def _language_matrix(self, max_bytes: int = 2 << 30):
        if self._lang_mat is not None:
            return self._lang_mat
        col = self.dataset.df["language_embedding"]
        dim = next((len(v) for v in col if v is not None), None)
        if dim is None or len(col) * dim * 2 > max_bytes:
            return None
        mat = np.zeros((len(col), dim), np.float16)
        has = np.zeros(len(col), bool)
        for i, v in enumerate(col):
            if v is not None:
                mat[i] = v
                has[i] = True
        self._lang_mat = mat
        self._lang_has = has
        return mat

    def get_vision_embedding(self, gbif_id: int) -> Optional[np.ndarray]:
        if gbif_id in self._vision_cache:
            self._vision_cache.move_to_end(gbif_id)
            return self._vision_cache[gbif_id]
        if self.vision_loader is None:
            return None
        emb = self.vision_loader.get(gbif_id, out_dtype=np.float16)
        if emb is not None:
            self._vision_cache.put(gbif_id, emb)
        return emb

    def get_language_embedding(self, gbif_id: int) -> Optional[np.ndarray]:
        if gbif_id in self._language_cache:
            self._language_cache.move_to_end(gbif_id)
            return self._language_cache[gbif_id]
        emb = None
        if self.language_loader is not None:
            emb = self.language_loader.get(gbif_id, out_dtype=np.float16)
        elif "language_embedding" in self.dataset.df:
            # reference schema: per-row 7168-d embedding in the observations
            # parquet itself (dashboard/dataset_config.json language_embeddings)
            row = self.dataset.row_for_id(gbif_id)
            if row is not None:
                v = self.dataset.df["language_embedding"].iloc[row]
                if v is not None:
                    emb = np.asarray(v, np.float16)
        if emb is not None:
            self._language_cache.put(gbif_id, emb)
        return emb

    def get_training_batch(
        self,
        observation_ids: Sequence[int],
        include_vision: bool = True,
        include_language: bool = True,
        pool_vision: bool = False,
        embedding_dtype=np.float16,
    ) -> Dict[str, Any]:
        """Model-ready batch (reference: dashboard/services/training_data.py:22-80)."""
        rows = np.asarray(
            [self.dataset.row_for_id(i) for i in observation_ids]
        )
        if any(r is None for r in rows):
            missing = [
                i for i, r in zip(observation_ids, rows) if r is None
            ]
            raise KeyError(f"unknown observation ids: {missing[:5]}")
        rows = rows.astype(int)
        xyzt = self.dataset.normalized_xyzt(
            rows, bbox=self.cfg.bbox, year_range=self.cfg.year_range
        )
        species = self.dataset.df["species_idx"].to_numpy(np.int32)[rows]
        batch: Dict[str, Any] = {
            "xyzt": xyzt,
            "modalities": {"species": species},
        }
        if include_vision and self.vision_loader is not None:
            # native threaded batch gather (csrc/fast_gather.c); float16 by
            # default halves host copies and H2D transfer — the model casts
            # to its compute dtype (bf16) on device anyway.
            vis, _ = self.vision_loader.get_batch(
                observation_ids, out_dtype=embedding_dtype
            )
            if pool_vision and vis.ndim >= 3:
                vis = vis.reshape(vis.shape[0], -1, vis.shape[-1]).mean(axis=1)
            elif vis.ndim > 3:
                vis = vis.reshape(vis.shape[0], -1, vis.shape[-1])
            batch["modalities"]["vision"] = vis
        if include_language:
            if self.language_loader is not None:
                lang, _ = self.language_loader.get_batch(
                    observation_ids, out_dtype=embedding_dtype
                )
                batch["modalities"]["language"] = lang
            elif "language_embedding" in self.dataset.df:
                # reference schema: embeddings live in the observations
                # parquet (see get_language_embedding). Fast path only for
                # fp16 requests (the matrix is stored fp16 — upcasting it
                # would silently truncate a wider embedding_dtype ask), and
                # only when at least one selected row HAS an embedding
                # (parity with the loop path, which omits the key for an
                # all-None batch).
                mat = (
                    self._language_matrix()
                    if np.dtype(embedding_dtype) == np.float16
                    else None
                )
                if mat is not None:
                    if bool(self._lang_has[rows].any()):
                        batch["modalities"]["language"] = mat[rows]
                else:
                    col = self.dataset.df["language_embedding"]
                    vals = [col.iloc[r] for r in rows]
                    dim = next(
                        (len(v) for v in vals if v is not None), None
                    )
                    if dim is not None:
                        # rows with a null embedding zero-fill instead of
                        # killing the whole batch build
                        zero = np.zeros(dim, embedding_dtype)
                        batch["modalities"]["language"] = np.stack(
                            [
                                zero if v is None
                                else np.asarray(v, embedding_dtype)
                                for v in vals
                            ]
                        )
        return batch

    def batch_iterator(
        self,
        batch_size: int,
        *,
        ids: Optional[Sequence[int]] = None,
        shuffle: bool = True,
        seed: int = 0,
        steps: Optional[int] = None,
        process_shard: bool = False,
        **batch_kwargs,
    ):
        """Epoch iterator over real observations → model-ready batches.

        With ``process_shard`` each process iterates its contiguous id shard
        by its ``torch.distributed`` rank (DistributedSampler parity,
        reference: hpc/train_distrbuted.py:176-190).
        """
        all_ids = np.asarray(
            ids if ids is not None else self.dataset.df["gbif_id"].to_numpy()
        )
        if process_shard:
            all_ids = all_ids[_process_local_batch_indices(len(all_ids))]
        rng = np.random.default_rng(seed)
        n_yielded = 0
        while True:
            order = (
                rng.permutation(len(all_ids)) if shuffle
                else np.arange(len(all_ids))
            )
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield self.get_training_batch(
                    all_ids[order[i : i + batch_size]], **batch_kwargs
                )
                n_yielded += 1
                if steps is not None and n_yielded >= steps:
                    return
            if steps is None:
                return
