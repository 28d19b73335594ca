"""Synthetic Earth-observation data generator: the port's copy of
``deepearth_tpu/data/synthetic.py`` (numpy only; importing the JAX
package's module imports JAX). For a seed its batches are the JAX
module's, bit for bit.

The "fake backend" that lets every layer be tested without the 206 GB
dataset or a cluster (reference: tests/test_data_generator.py:16-330).

Generates procedurally structured observations over a spatiotemporal grid:
species cluster spatially, embeddings are deterministic functions of species
plus noise, weather follows seasonal cycles — so models can actually learn
from it and loss curves are meaningful in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


@dataclass
class SyntheticConfig:
    n_species: int = 232
    n_clusters: int = 12
    bbox_lat: tuple = (28.03, 28.98)  # Central Florida
    bbox_lon: tuple = (-81.93, -80.90)
    year_range: tuple = (2010, 2025)
    vision_dim: int = 1408
    vision_patches: int = 16
    language_dim: int = 7168
    weather_dim: int = 5
    noise: float = 0.05
    seed: int = 0


MODALITY_KEYS = ("species", "vision", "language", "weather")


class SyntheticEarthDataGenerator:
    """Procedural observation generator with learnable structure."""

    def __init__(self, cfg: Optional[SyntheticConfig] = None):
        self.cfg = cfg or SyntheticConfig()
        rng = np.random.default_rng(self.cfg.seed)
        c = self.cfg
        # cluster centers in normalized [0,1]² and their species distributions
        self.cluster_centers = rng.random((c.n_clusters, 2))
        self.cluster_species = rng.integers(0, c.n_species, size=(c.n_clusters, 8))
        # per-species embedding prototypes (the learnable signal)
        self.species_vision_proto = rng.standard_normal(
            (c.n_species, c.vision_dim)
        ).astype(np.float32) * 0.5
        self.species_language_proto = rng.standard_normal(
            (c.n_species, c.language_dim)
        ).astype(np.float32) * 0.5

    def sample_observations(
        self, n: int, seed: Optional[int] = None,
        modalities: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Generate n observations with the training-batch schema
        (reference: dashboard/services/training_data.py:22-80).

        With ``modalities``, the vision and language noise is drawn only as
        far as they need: the two are the last draws of the stream (vision,
        then language), so every value returned is the JAX module's bit for
        bit, and a species-only batch of 4096 skips ~120M normal draws."""
        c = self.cfg
        rng = np.random.default_rng(c.seed + 1 if seed is None else seed)
        cluster = rng.integers(0, c.n_clusters, n)
        xy = np.clip(
            self.cluster_centers[cluster]
            + rng.standard_normal((n, 2)) * 0.05,
            0.0, 1.0,
        )
        lat = c.bbox_lat[0] + xy[:, 0] * (c.bbox_lat[1] - c.bbox_lat[0])
        lon = c.bbox_lon[0] + xy[:, 1] * (c.bbox_lon[1] - c.bbox_lon[0])
        alt = rng.random(n).astype(np.float64) * 100.0
        t_norm = rng.random(n).astype(np.float64)  # normalized over year_range

        species = self.cluster_species[
            cluster, rng.integers(0, self.cluster_species.shape[1], n)
        ].astype(np.int32)

        wanted = set(MODALITY_KEYS if modalities is None else modalities)
        out = {}
        if wanted & {"vision", "language"}:
            out["vision"] = (
                self.species_vision_proto[species][:, None, :]
                + rng.standard_normal((n, c.vision_patches, c.vision_dim)).astype(np.float32)
                * c.noise
            )
        if "language" in wanted:
            out["language"] = (
                self.species_language_proto[species]
                + rng.standard_normal((n, c.language_dim)).astype(np.float32) * c.noise
            )
        # seasonal weather: deterministic function of time + location
        phase = 2 * np.pi * (t_norm * (c.year_range[1] - c.year_range[0]) % 1.0)
        weather = np.stack(
            [
                20 + 8 * np.sin(phase) + 2 * xy[:, 0],
                60 + 20 * np.cos(phase),
                np.maximum(0, 5 * np.sin(phase * 2)),
                10 + 3 * xy[:, 1],
                1013 + 5 * np.cos(phase),
            ],
            axis=-1,
        ).astype(np.float32)
        weather = (weather - weather.mean(0)) / (weather.std(0) + 1e-6)

        xyzt = np.stack(
            [xy[:, 0], xy[:, 1], alt / 100.0, t_norm], axis=-1
        ).astype(np.float32)

        return {
            "xyzt": xyzt,
            "lat": lat,
            "lon": lon,
            "alt": alt,
            "species": species,
            **out,
            "weather": weather,
        }

    def batch_iterator(
        self,
        batch_size: int,
        modalities: Sequence[str] = ("species",),
        seed: int = 1234,
        steps: Optional[int] = None,
    ) -> Iterator[Dict[str, object]]:
        """Infinite (or bounded) iterator of DeepEarthModel batches."""
        step = 0
        while steps is None or step < steps:
            obs = self.sample_observations(batch_size, seed=seed + step,
                                           modalities=modalities)
            yield observations_to_batch(obs, modalities)
            step += 1


def observations_to_batch(
    obs: Dict[str, np.ndarray], modalities: Sequence[str]
) -> Dict[str, object]:
    """Convert a raw observation dict to the model's batch schema."""
    return {
        "xyzt": obs["xyzt"],
        "modalities": {m: obs[m] for m in modalities if m in obs},
    }
