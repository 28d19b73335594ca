"""Simple user-facing API, the PyTorch port of ``deepearth_tpu/api.py``
(reference: deepearth_api.py:17-328).

One-liner data-source registration and prediction:

    >>> from deepearth_tpu_torch.api import DeepEarth
    >>> earth = DeepEarth()  # on the card; DeepEarth(device="cpu") on the CPU
    >>> earth.register("temperature", shape=(1,), type="numerical")
    >>> earth.register("species", type="categorical", num_classes=232)
    >>> emb = earth.predict(location=(28.5, -81.4), time="2024-06-15",
    ...                     data={"temperature": [22.3]})

Prediction returns the fused representation as a float32 numpy array (in
bf16 compute its values are bf16 values); reconstruction heads are
available via ``predict_batch(..., return_reconstructions=True)``.

As in the JAX package, the model is built at the first prediction, over the
sources present in that batch: flax makes a module's parameters when it
first runs, so a JAX model has none for a source its first batch left out.
The port builds the same modules, so the two packages' parameter trees are
alike, and a later batch holding a source the model was built without
raises, as applying the JAX model to it does.

``save`` / ``load`` keep the JAX package's layout: ``registry.json`` and
``params.pkl``, the flax parameter tree as numpy arrays. A model saved by
either package loads into the other and predicts the same embedding.
``DeepEarth(seed=s)`` draws its parameters from a ``torch.Generator``
seeded with ``s``: deterministic, but not the JAX package's
``PRNGKey(s)`` init; parity between the two goes through ``save`` /
``load``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import pickle
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .configs import (
    DeepEarthConfig,
    Grid4DConfig,
    ModalityConfig,
    TransformerConfig,
)
from .convert import flax_params_from_model, load_flax_params
from .models import DeepEarthModel


def _parse_time(t: Union[str, float, _dt.datetime, None]) -> float:
    """Time → normalized [0,1] over 2000-2050 (naive, matching the
    reference's simple coordinate prep — deepearth_api.py:240-268)."""
    if t is None:
        return 0.5
    if isinstance(t, (int, float)):
        return float(np.clip(t, 0.0, 1.0))
    if isinstance(t, str):
        t = _dt.datetime.fromisoformat(t)
    if isinstance(t, _dt.datetime):
        start = _dt.datetime(2000, 1, 1)
        end = _dt.datetime(2050, 1, 1)
        return float(
            np.clip((t - start).total_seconds() / (end - start).total_seconds(), 0, 1)
        )
    raise TypeError(f"cannot parse time {t!r}")


def load_file(path: str) -> np.ndarray:
    """Load a data file into an array. CSV/NPY/NPZ natively; GeoTIFF and
    NetCDF through optional libraries when present, else PIL and scipy
    (reference supports them via rasterio/netCDF4 — deepearth_api.py:270)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext == ".npz":
        data = np.load(path)
        return data[list(data.files)[0]]
    if ext == ".csv":
        return np.genfromtxt(path, delimiter=",", skip_header=1)
    if ext in (".tif", ".tiff"):
        return load_geotiff(path)
    if ext in (".nc", ".nc4"):
        return load_netcdf(path)
    raise ValueError(f"unsupported file type {ext}")


def load_geotiff(path: str) -> np.ndarray:
    """GeoTIFF → (bands, H, W) array (reference: deepearth_api.py:270).

    rasterio if available (reads CRS-aware rasters), otherwise PIL's TIFF
    reader (pixel data only — geo metadata is ignored, which matches how the
    reference used the raster: as a plain array)."""
    try:
        import rasterio

        with rasterio.open(path) as src:
            return src.read()
    except ImportError:
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            return img[None]
        return np.moveaxis(img, -1, 0)  # (H, W, C) → (C, H, W)


def load_netcdf(path: str, variable: Optional[str] = None) -> np.ndarray:
    """NetCDF → array of ``variable`` (default: first non-coordinate var).

    netCDF4/xarray if available (NetCDF-4/HDF5), otherwise scipy's
    NetCDF-3 reader (reference: deepearth_api.py:270)."""
    try:
        import netCDF4  # type: ignore

        with netCDF4.Dataset(path) as ds:
            name = variable or next(
                n for n, v in ds.variables.items() if v.ndim >= 2
            )
            return np.asarray(ds.variables[name][:])
    except ImportError:
        pass
    try:
        import xarray as xr  # type: ignore

        ds = xr.open_dataset(path)
        name = variable or next(iter(ds.data_vars))
        return ds[name].to_numpy()
    except ImportError:
        pass
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as ds:
        candidates = {
            n: v for n, v in ds.variables.items() if n not in ds.dimensions
        }
        name = variable or next(
            (n for n, v in candidates.items() if v.data.ndim >= 2),
            next(iter(candidates)),
        )
        return np.array(ds.variables[name].data)


def _modality_names(params: Dict[str, Any]) -> list:
    """The sources a flax parameter tree holds modules for."""
    return sorted(k.split("_", 1)[1] for k in params
                  if k.startswith(("embed_", "encoder_")))


class DeepEarth:
    """Register data sources, then predict fused embeddings anywhere/anytime.

    Args:
        hidden_dim, n_layers: the fusion stack's width and depth.
        seed: the parameters' seed (a ``torch.Generator`` on ``device``).
        device: where the model runs: the card unless the caller names
            another (``device="cpu"``). Without a card the default raises.
    """

    def __init__(
        self,
        hidden_dim: int = 256,
        n_layers: int = 4,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: DeepEarth runs on the card by default; pass "
                "device='cpu' to run it on the CPU")
        self.device = device
        self._config = DeepEarthConfig(
            hidden_dim=hidden_dim,
            n_heads=max(4, hidden_dim // 64),
            n_layers=n_layers,
            grid4d=Grid4DConfig(
                n_spatial_levels=8, n_temporal_levels=4,
                hash_table_size=2 ** 15,
            ),
            modality_encoder=TransformerConfig(
                hidden_dim=hidden_dim // 2, n_heads=4, n_layers=2
            ),
        )
        self._seed = seed
        self._model: Optional[DeepEarthModel] = None
        # requests of a threaded server may reach the first build together
        self._build_lock = threading.Lock()
        self.sources: Dict[str, Dict[str, Any]] = {}

    # -- registration -------------------------------------------------------- #

    def register(
        self,
        name: str,
        shape: Optional[Sequence[int]] = None,
        type: str = "numerical",
        num_classes: Optional[int] = None,
        n_tokens: int = 1,
    ) -> "DeepEarth":
        """Register a data source (reference: deepearth_api.py:77-120)."""
        if self._model is not None:
            raise RuntimeError(
                "cannot register new sources after the model is built; "
                "create a new DeepEarth instance"
            )
        if type == "categorical":
            if num_classes is None:
                raise ValueError("categorical sources need num_classes")
            cfg = ModalityConfig(
                name=name, encoding_type="learned_embedding",
                input_type="categorical", vocab_size=num_classes,
            )
        else:
            if shape is None:
                raise ValueError("numerical sources need a shape")
            dim = int(np.prod(shape))
            cfg = ModalityConfig(
                name=name, input_dim=dim, n_tokens=n_tokens,
                encoder_layers=1, encoder_heads=4,
            )
        self._config.add_modality(cfg)
        self.sources[name] = {
            "shape": tuple(shape) if shape is not None else (),
            "type": type,
            "num_classes": num_classes,
        }
        return self

    # -- model lifecycle ------------------------------------------------------ #

    def _build(self, names: Sequence[str]) -> None:
        """The model over the registered sources ``names``, in eval mode."""
        cfg = dataclasses.replace(self._config, modalities={
            n: self._config.modalities[n] for n in names})
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self._model = DeepEarthModel(cfg, generator=gen,
                                     device=self.device).eval()

    def _prepare_batch(
        self,
        locations: np.ndarray,
        times: Sequence,
        data: Dict[str, Any],
    ) -> Dict[str, Any]:
        b = locations.shape[0]
        lat = locations[:, 0]
        lon = locations[:, 1]
        alt = locations[:, 2] if locations.shape[1] > 2 else np.zeros(b)
        # naive global normalization (reference: deepearth_api.py:240-268),
        # in float64 on the host and cast to float32 before the copy
        xyzt = np.stack(
            [
                (lat + 90.0) / 180.0,
                (lon + 180.0) / 360.0,
                np.clip(alt / 10_000.0, 0, 1),
                np.asarray([_parse_time(t) for t in times]),
            ],
            axis=-1,
        ).astype(np.float32)
        modalities = {}
        for name, spec in self.sources.items():
            if name not in data:
                continue
            arr = np.asarray(data[name])
            if spec["type"] == "categorical":
                modalities[name] = arr.reshape(b).astype(np.int32)
            else:
                modalities[name] = arr.reshape(
                    (b, -1)
                ).astype(np.float32)
        return {"xyzt": torch.from_numpy(xyzt).to(self.device), "modalities": {
            k: torch.from_numpy(v).to(self.device)
            for k, v in modalities.items()
        }}

    # -- prediction ----------------------------------------------------------- #

    def predict(
        self,
        location: Tuple[float, ...],
        time: Union[str, float, None] = None,
        data: Optional[Dict[str, Any]] = None,
    ) -> np.ndarray:
        """Single-point prediction → fused embedding (reference:
        deepearth_api.py:122-170)."""
        data = data or {}
        batched = {
            k: np.asarray(v)[None] if np.asarray(v).ndim <= 1 else np.asarray(v)
            for k, v in data.items()
        }
        emb, _ = self._predict_raw(
            np.asarray(location, np.float64)[None], [time], batched
        )
        return emb[0]

    def predict_batch(
        self,
        locations: Sequence[Tuple[float, ...]],
        times: Optional[Sequence] = None,
        data: Optional[Dict[str, Any]] = None,
        return_reconstructions: bool = False,
    ):
        locs = np.asarray(locations, np.float64)
        times = times if times is not None else [None] * len(locs)
        emb, recon = self._predict_raw(locs, times, data or {})
        if return_reconstructions:
            return emb, recon
        return emb

    def _predict_raw(self, locs, times, data):
        """(fused representation, {head: reconstruction}) as float32 numpy
        arrays."""
        batch = self._prepare_batch(locs, times, data)
        if self._model is None:
            with self._build_lock:
                if self._model is None:
                    self._build(sorted(batch["modalities"]))
        unbuilt = set(batch["modalities"]) - set(self._model.modality_names)
        if unbuilt:
            raise ValueError(
                f"the model has no parameters for {sorted(unbuilt)}: it was "
                f"built over {self._model.modality_names}, the sources of its "
                f"first batch (or of the loaded tree)")
        with torch.inference_mode():
            out = self._model(batch)
            emb = out["fused_representation"].float()
            recon = {k: v.float() for k, v in out["reconstructions"].items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return emb.cpu().numpy(), {k: v.cpu().numpy()
                                       for k, v in recon.items()}

    # -- persistence ----------------------------------------------------------- #

    def save(self, path: str) -> None:
        """Save params + source registry (reference: deepearth_api.py:296-308)
        in the JAX package's layout."""
        if self._model is None:
            raise RuntimeError("nothing to save: the model is built at the "
                               "first predict")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "registry.json"), "w") as f:
            json.dump(self.sources, f)
        with open(os.path.join(path, "params.pkl"), "wb") as f:
            pickle.dump(flax_params_from_model(self._model), f)

    def load(self, path: str) -> "DeepEarth":
        """Register the saved sources and install the saved parameters (a
        tree saved by either package)."""
        with open(os.path.join(path, "registry.json")) as f:
            sources = json.load(f)
        for name, spec in sources.items():
            if name not in self.sources:
                self.register(
                    name,
                    shape=spec["shape"] or None,
                    type=spec["type"],
                    num_classes=spec["num_classes"],
                )
        with open(os.path.join(path, "params.pkl"), "rb") as f:
            params = pickle.load(f)
        self._build(_modality_names(params))
        load_flax_params(self._model, params)
        return self


# -- functional API (reference: deepearth_api.py:320-328) --------------------- #

_GLOBAL: Optional[DeepEarth] = None


def init(**kwargs) -> DeepEarth:
    global _GLOBAL
    _GLOBAL = DeepEarth(**kwargs)
    return _GLOBAL


def register(name: str, **kwargs) -> DeepEarth:
    if _GLOBAL is None:
        init()
    return _GLOBAL.register(name, **kwargs)


def predict(location, time=None, data=None) -> np.ndarray:
    if _GLOBAL is None:
        raise RuntimeError("call init() and register() first")
    return _GLOBAL.predict(location, time, data)
