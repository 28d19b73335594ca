"""npy-file-per-sample dataset (HPC storage layout): the port's copy of
``deepearth_tpu/data/npy_dataset.py`` (numpy only).

Parity with the reference's HPC dataset (reference:
hpc/train_distrbuted.py:62-157): samples are listed in
``<split>_metadata.json`` with per-sample file references under
``coordinates/``, ``images/``, ``text/``, and ``modalities/``; items are
loaded lazily with a FIFO cache. Output dicts use this framework's batch
schema (numpy) so :func:`collate_observations` / ``device_prefetch``
consume them directly.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np


class NpySampleDataset:
    """Lazy npy-per-sample dataset with FIFO caching.

    Layout (reference: hpc/train_distrbuted.py:80-84,133-157)::

        <root>/<split>_metadata.json    {"samples": [{"id", "coord_file",
                                          "image_file"?, "text_file"?,
                                          "modalities"? {name: file}}, ...]}
        <root>/coordinates/<file>.npy   (4,) xyzt
        <root>/images/<file>.npy        image array
        <root>/text/<file>.npz          input_ids, attention_mask
        <root>/modalities/<file>.npy    arbitrary modality vector
    """

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        max_samples: Optional[int] = None,
        cache_size: int = 1000,
    ):
        self.data_path = data_path
        self.split = split
        self.cache_size = cache_size
        self._cache: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        with open(os.path.join(data_path, f"{split}_metadata.json")) as f:
            self.metadata = json.load(f)
        self.samples: List[Dict[str, Any]] = self.metadata["samples"]
        if max_samples:
            self.samples = self.samples[:max_samples]

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, sub: str, filename: str) -> np.ndarray:
        return np.load(os.path.join(self.data_path, sub, filename))

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx in self._cache:
            return self._cache[idx]
        info = self.samples[idx]
        data: Dict[str, Any] = {
            "xyzt": self._load("coordinates", info["coord_file"]).astype(
                np.float32
            ),
            "sample_id": info["id"],
        }
        if "image_file" in info:
            data["images"] = self._load("images", info["image_file"]).astype(
                np.float32
            )
        if "text_file" in info:
            txt = np.load(
                os.path.join(self.data_path, "text", info["text_file"])
            )
            data["input_ids"] = np.asarray(txt["input_ids"], np.int32)
            data["attention_mask"] = np.asarray(txt["attention_mask"], bool)
        if "modalities" in info:
            data.update(
                {
                    name: self._load("modalities", fname).astype(np.float32)
                    for name, fname in info["modalities"].items()
                }
            )
        if len(self._cache) >= self.cache_size:
            self._cache.popitem(last=False)  # FIFO eviction
        self._cache[idx] = data
        return data

    def batch_iterator(self, batch_size: int, modalities=(), shuffle=True,
                       seed: int = 0, steps: Optional[int] = None):
        """Yield collated batches in the framework schema."""
        from .batches import collate_observations

        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        n_yielded = 0
        while steps is None or n_yielded < steps:
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                obs = [self[int(j)] for j in order[i : i + batch_size]]
                yield collate_observations(obs, modalities)
                n_yielded += 1
                if steps is not None and n_yielded >= steps:
                    return
            if steps is None:
                return


def write_npy_dataset(
    root: str,
    split: str,
    samples: List[Dict[str, Any]],
) -> None:
    """Writer counterpart: persist sample dicts into the HPC layout.

    Each sample dict: {"id", "xyzt", optional "images", optional
    ("input_ids", "attention_mask"), optional "modalities": {name: array}}.
    """
    meta = []
    for sub in ("coordinates", "images", "text", "modalities"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for s in samples:
        sid = s["id"]
        entry: Dict[str, Any] = {"id": sid, "coord_file": f"{sid}.npy"}
        np.save(
            os.path.join(root, "coordinates", f"{sid}.npy"),
            np.asarray(s["xyzt"], np.float32),
        )
        if "images" in s:
            entry["image_file"] = f"{sid}.npy"
            np.save(
                os.path.join(root, "images", f"{sid}.npy"),
                np.asarray(s["images"], np.float32),
            )
        if "input_ids" in s:
            entry["text_file"] = f"{sid}.npz"
            np.savez(
                os.path.join(root, "text", f"{sid}.npz"),
                input_ids=np.asarray(s["input_ids"], np.int32),
                attention_mask=np.asarray(
                    s.get(
                        "attention_mask",
                        np.ones_like(s["input_ids"], bool),
                    )
                ),
            )
        if "modalities" in s:
            entry["modalities"] = {}
            for name, arr in s["modalities"].items():
                fname = f"{sid}_{name}.npy"
                entry["modalities"][name] = fname
                np.save(
                    os.path.join(root, "modalities", fname),
                    np.asarray(arr, np.float32),
                )
        meta.append(entry)
    with open(os.path.join(root, f"{split}_metadata.json"), "w") as f:
        json.dump({"samples": meta}, f)
