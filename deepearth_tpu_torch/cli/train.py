"""Training CLI of the port: argparse + optional YAML override merge, the
counterpart of the JAX package's ``scripts/train.py`` (reference:
hpc/train_distrbuted.py:652-724 CLI, yaml merge :716-723).

Examples:
    # synthetic data on the card
    python -m deepearth_tpu_torch.cli.train --steps 500 --batch-size 64 \\
        --checkpoint-dir ckpts/

    # a real dataset directory (observations.parquet + mmap stores)
    python -m deepearth_tpu_torch.cli.train --data-dir data/ --steps 1000

    # the same on the CPU
    python -m deepearth_tpu_torch.cli.train --device cpu --steps 2

It takes the JAX script's arguments plus ``--device`` (``cuda``, the
default, or ``cpu``), builds the same ``DeepEarthConfig`` and modality
registry, and writes the same ``config.json`` beside its checkpoints.
Batches reach the card through ``data.device_prefetch`` (pinned memory, a
copy stream); with ``--data-dir`` they are assembled in a background thread
first (``data.threaded_producer``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..configs import (
    DeepEarthConfig,
    Grid4DConfig,
    ModalityConfig,
    TransformerConfig,
)
from ..data import (
    DatasetConfig,
    MMapEmbeddingLoader,
    ObservationDataset,
    SyntheticConfig,
    SyntheticEarthDataGenerator,
    UnifiedDataCache,
    device_prefetch,
    threaded_producer,
)
from ..models import DeepEarthModel
from ..training import LossWeights, Trainer
from ..utils.logging import JSONLMetricWriter, setup_logging

DISTRIBUTED_TODO = ("--distributed needs the multi-GPU slice, which is not "
                    "ported yet (ROADMAP.md Queue 1, item 15)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepEarth trainer (PyTorch)")
    p.add_argument("--config", type=str, default=None, help="YAML override file")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--metrics-jsonl", type=str, default=None)
    p.add_argument(
        "--modalities", type=str, default="species",
        help="comma list from: species,weather,vision,language",
    )
    p.add_argument(
        "--data-dir", type=str, default=None,
        help="real dataset directory (observations.parquet + optional "
        "vision/language mmap stores + dataset_config.json); omit for "
        "synthetic data",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains: cuda (the default) or cpu")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments; with ``--config``, the YAML file's values override the
    defaults, and an argument given on the command line wins over both."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = build_parser()
    args = p.parse_args(argv)
    if args.config:
        import yaml

        with open(args.config) as f:
            overrides = yaml.safe_load(f) or {}
        explicit = {
            a.dest for a in p._actions
            if any(opt in argv for opt in a.option_strings)
        }
        for k, v in overrides.items():
            key = k.replace("-", "_")
            if hasattr(args, key) and key not in explicit:
                setattr(args, key, v)
    return args


def make_config(args) -> DeepEarthConfig:
    """The configuration ``scripts/train.py`` builds from its arguments."""
    cfg = DeepEarthConfig(
        hidden_dim=args.hidden_dim,
        n_heads=max(4, args.hidden_dim // 64),
        n_layers=args.n_layers,
        grid4d=Grid4DConfig(
            n_spatial_levels=12, n_temporal_levels=6, hash_table_size=2 ** 17
        ),
        modality_encoder=TransformerConfig(
            hidden_dim=args.hidden_dim // 2, n_heads=4, n_layers=2
        ),
    )
    cfg.optimizer.learning_rate = args.learning_rate
    cfg.optimizer.warmup_steps = args.warmup_steps
    cfg.optimizer.total_steps = args.steps
    return cfg


def synthetic_modalities(syn_cfg: SyntheticConfig) -> Dict[str, ModalityConfig]:
    """The modality registry of the synthetic path."""
    return {
        "species": ModalityConfig(
            name="species", encoding_type="learned_embedding",
            input_type="categorical", vocab_size=232,
        ),
        "weather": ModalityConfig(
            name="weather", input_dim=syn_cfg.weather_dim, n_tokens=1,
            encoder_layers=1, encoder_heads=4,
        ),
        "vision": ModalityConfig(
            name="vision", input_dim=syn_cfg.vision_dim, n_tokens=4,
            encoder_layers=1, encoder_heads=4,
        ),
        "language": ModalityConfig(
            name="language", input_dim=syn_cfg.language_dim, n_tokens=2,
            encoder_layers=1, encoder_heads=4,
        ),
    }


def native_seq_lens(batch: Dict[str, Any]) -> Dict[str, int]:
    """Each (B, S, Din) modality's S: the JAX model sizes its encoders'
    position tables from the first batch, the port's from these."""
    return {name: int(np.shape(x)[1])
            for name, x in batch.get("modalities", {}).items()
            if np.ndim(x) == 3}


def run(args, cfg: DeepEarthConfig, batches: Iterable[Dict[str, Any]],
        first_batch: Dict[str, Any]):
    """Build the model and its trainer, resume if asked, train
    ``args.steps`` steps over ``batches``, save and log. Returns
    ``(state, metrics)``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to train on the CPU")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = DeepEarthModel(cfg, generator=gen, device=device,
                           native_seq_lens=native_seq_lens(first_batch))
    trainer = Trainer(
        model, cfg, LossWeights(contrastive=0.01),
        checkpoint_dir=args.checkpoint_dir, seed=args.seed,
    )
    state = trainer.init_state()
    if args.resume and args.checkpoint_dir:
        state = trainer.restore(state)
    state, metrics = trainer.fit(
        state,
        batches,
        args.steps,
        log_every=args.log_every,
        save_every=args.save_every if args.checkpoint_dir else 0,
    )
    if args.checkpoint_dir:
        trainer.save(state, int(state.step))
    if args.metrics_jsonl:
        w = JSONLMetricWriter(args.metrics_jsonl)
        w.log(metrics, int(state.step))
        w.close()
    print({k: round(v, 5) for k, v in metrics.items()})
    return state, metrics


def train_synthetic(args, cfg: DeepEarthConfig):
    """The synthetic path: ``--modalities`` from the synthetic registry,
    batches from ``SyntheticEarthDataGenerator`` through
    ``device_prefetch``."""
    wanted = tuple(m.strip() for m in args.modalities.split(",") if m.strip())
    syn_cfg = SyntheticConfig()
    registry = synthetic_modalities(syn_cfg)
    for m in wanted:
        if m not in registry:
            raise SystemExit(
                f"unknown modality {m!r}; choose from {list(registry)}"
            )
        cfg.add_modality(registry[m])
    gen = SyntheticEarthDataGenerator(syn_cfg)
    batches = device_prefetch(
        gen.batch_iterator(args.batch_size, modalities=wanted), size=2,
        device=args.device,
    )
    first_batch = next(
        gen.batch_iterator(args.batch_size, modalities=wanted, steps=1)
    )
    return run(args, cfg, batches, first_batch)


def open_stores(data_dir: str) -> Dict[str, MMapEmbeddingLoader]:
    """The vision and language mmap stores of a dataset directory, where
    their ``.bin`` files exist."""
    loaders = {}
    for store in ("vision", "language"):
        base = os.path.join(data_dir, store)
        if os.path.exists(base + ".bin"):
            loaders[store] = MMapEmbeddingLoader(base)
    return loaders


def train_on_dataset(args, cfg: DeepEarthConfig, ds: ObservationDataset,
                     loaders: Dict[str, MMapEmbeddingLoader],
                     dcfg: Optional[DatasetConfig] = None):
    """The ``--data-dir`` path after the parquet read: species, and vision
    and language where their stores exist, from ``ds`` and ``loaders``;
    batches assembled by ``UnifiedDataCache`` in a background thread
    (``threaded_producer``), then sent to the device by
    ``device_prefetch``."""
    cache = UnifiedDataCache(
        ds, dcfg or DatasetConfig(), loaders.get("vision"),
        loaders.get("language")
    )
    cfg.add_modality(
        ModalityConfig(
            name="species", encoding_type="learned_embedding",
            input_type="categorical", vocab_size=ds.n_species,
        )
    )
    if "vision" in loaders:
        cfg.add_modality(
            ModalityConfig(
                name="vision",
                input_dim=loaders["vision"].embedding_shape[-1],
                n_tokens=16, encoder_layers=1, encoder_heads=8,
            )
        )
    if "language" in loaders:
        cfg.add_modality(
            ModalityConfig(
                name="language",
                input_dim=loaders["language"].embedding_shape[-1],
                n_tokens=4, encoder_layers=1, encoder_heads=8,
            )
        )

    def make_batches():
        return cache.batch_iterator(
            args.batch_size, seed=args.seed, steps=args.steps + 1,
        )

    batches = device_prefetch(threaded_producer(make_batches), size=2,
                              device=args.device)
    first_batch = next(
        cache.batch_iterator(args.batch_size, steps=1, shuffle=False)
    )
    return run(args, cfg, batches, first_batch)


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default) and train. Returns
    ``(state, metrics)``."""
    args = parse_args(argv)
    setup_logging()
    if args.distributed:
        raise NotImplementedError(DISTRIBUTED_TODO)
    cfg = make_config(args)
    if not args.data_dir:
        return train_synthetic(args, cfg)
    # real dataset: observations.parquet + mmap embedding stores
    # (reference training path: training/deepearth_multimodal_training.py)
    dcfg_path = os.path.join(args.data_dir, "dataset_config.json")
    dcfg = (
        DatasetConfig.from_json(dcfg_path)
        if os.path.exists(dcfg_path)
        else DatasetConfig()
    )
    ds = ObservationDataset.from_parquet(
        os.path.join(args.data_dir, "observations.parquet")
    )
    return train_on_dataset(args, cfg, ds, open_stores(args.data_dir), dcfg)


if __name__ == "__main__":
    main()
