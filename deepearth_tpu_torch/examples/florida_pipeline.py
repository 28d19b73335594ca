"""End-to-end Central-Florida-shaped pipeline demo on the PyTorch port, the
counterpart of ``examples/florida_pipeline.py``.

Chains the whole data and training stack the way the reference's working
C-stack did (reference call stack:
training/deepearth_multimodal_training.py:325):

  synthetic observations -> parquet + mmap embedding stores ->
  ObservationDataset + UnifiedDataCache -> spatial/temporal splits ->
  masked multimodal training -> linear-probe evaluation + ecosystem
  analysis.

Writes parquet through pandas. Shrunken embedding dims.

    python -m deepearth_tpu_torch.examples.florida_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import ModalityConfig, tiny_config
from ..data import (
    DatasetConfig,
    ObservationDataset,
    SplitConfig,
    SyntheticConfig,
    SyntheticEarthDataGenerator,
    UnifiedDataCache,
    convert_arrays_to_store,
    create_spatial_temporal_split,
    device_prefetch,
)
from ..evaluation import DeepEarthEvaluator, analyze_ecosystems
from ..models import DeepEarthModel
from ..training import LossWeights, Trainer

STEPS, N_OBS = 80, 600
SEED = 0


def main(device="cuda", steps: int = STEPS) -> dict:
    """Run the pipeline with the model and the probe on ``device`` (the
    card unless the caller asks for the CPU); the model's draws come from
    a generator seeded with 0. Returns the training loss, the probe's
    accuracy and the ecosystem clusters' silhouette."""
    import pandas as pd

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card by "
                           "default; pass device='cpu' (--device cpu)")
    t_start = time.time()
    gen = SyntheticEarthDataGenerator(
        SyntheticConfig(vision_dim=64, vision_patches=4, language_dim=96))
    obs = gen.sample_observations(N_OBS, seed=0)
    ids = np.arange(10_000, 10_000 + N_OBS)

    with tempfile.TemporaryDirectory() as td:
        # 1) the storage layer: parquet observations + mmap stores
        df = pd.DataFrame({
            "gbif_id": ids,
            "species": obs["species"],
            "latitude": obs["lat"],
            "longitude": obs["lon"],
            "altitude": obs["alt"],
            "year": (2010 + obs["xyzt"][:, 3] * 15).astype(int),
            "month": np.ones(N_OBS, int) * 6,
        })
        pq = os.path.join(td, "observations.parquet")
        df.to_parquet(pq)
        vstore = convert_arrays_to_store(os.path.join(td, "vision"), ids,
                                         obs["vision"])
        lstore = convert_arrays_to_store(os.path.join(td, "language"), ids,
                                         obs["language"])
        print(f"storage built: {N_OBS} obs, vision {vstore.embedding_shape}, "
              f"language {lstore.embedding_shape}")

        # 2) dataset + cache + splits
        ds = ObservationDataset.from_parquet(pq)
        cache = UnifiedDataCache(ds, DatasetConfig(), vstore, lstore)
        split = create_spatial_temporal_split(
            df["latitude"].to_numpy(), df["longitude"].to_numpy(),
            df["year"].to_numpy(),
            SplitConfig(n_spatial_regions=2, region_radius_km=4.0,
                        min_separation_km=8.0, holdout_years=(2024,)))
        train_ids = ids[split["train_idx"]]
        test_ids = ids[split["temporal_test_idx"]]
        print(f"split: train {len(train_ids)}, spatial test "
              f"{len(split['spatial_test_idx'])}, temporal test "
              f"{len(test_ids)}")

        # 3) model + training on masked multimodal reconstruction
        cfg = tiny_config()
        cfg.modalities.clear()
        cfg.add_modality(ModalityConfig(
            name="species", encoding_type="learned_embedding",
            input_type="categorical", vocab_size=232))
        cfg.add_modality(ModalityConfig(name="vision", input_dim=64,
                                        n_tokens=2, encoder_layers=1,
                                        encoder_heads=2))
        cfg.add_modality(ModalityConfig(name="language", input_dim=96,
                                        n_tokens=1, encoder_layers=1,
                                        encoder_heads=2))
        cfg.optimizer.learning_rate = 2e-3
        cfg.optimizer.warmup_steps = 5
        cfg.optimizer.total_steps = steps
        rng = np.random.default_rng(0)

        def batches(id_pool, bs=16):
            while True:
                sel = rng.choice(id_pool, bs, replace=False)
                yield cache.get_training_batch(sel)

        # the JAX example draws its init batch first
        first = next(batches(train_ids))
        model = DeepEarthModel(
            cfg, generator=torch.Generator(device=device).manual_seed(SEED),
            device=device, native_seq_lens={
                name: x.shape[1] for name, x in first["modalities"].items()
                if np.ndim(x) == 3})
        trainer = Trainer(model, cfg, LossWeights(contrastive=0.05),
                          seed=SEED)
        state = trainer.init_state()
        state, metrics = trainer.fit(
            state, device_prefetch(batches(train_ids), device=device),
            num_steps=steps, log_every=max(1, steps // 2))
        loss = metrics["loss/total"]
        assert np.isfinite(loss), f"non-finite loss {loss}"
        print(f"trained {steps} steps: loss {loss:.4f}, species acc "
              f"{metrics.get('acc/species', 0):.3f}")

        # 4) frozen-feature evaluation on the temporal holdout
        def feature_fn(batch):
            batch = next(device_prefetch([batch], device=device))
            with torch.no_grad():
                fused = model.eval()(batch)["fused_representation"]
            return fused.float().cpu().numpy()

        eval_ids = test_ids[:128] if len(test_ids) >= 16 else train_ids[:128]
        eval_batch = cache.get_training_batch(eval_ids)
        feats = feature_fn(eval_batch)
        labels = np.asarray(eval_batch["modalities"]["species"])
        ev = DeepEarthEvaluator(feature_fn, device=device)
        res = ev.evaluate_classification(feats, labels, n_classes=232,
                                         steps=200)
        acc = res.metrics["accuracy"]
        print(f"temporal-holdout probe: acc {acc:.3f} (chance ≈ "
              f"{1 / len(np.unique(labels)):.3f})")

        # 5) ecosystem clustering of learned embeddings
        eco = analyze_ecosystems(feats, labels,
                                 np.asarray(eval_batch["xyzt"][:, 0]),
                                 np.asarray(eval_batch["xyzt"][:, 1]),
                                 n_clusters=4)
        assert len(eco["clusters"]) == 4 and 0.0 <= acc <= 1.0, (eco, acc)
        print(f"ecosystems: {len(eco['clusters'])} clusters, silhouette "
              f"{eco['silhouette']:.3f}")

    print(f"\npipeline demo completed in {time.time() - t_start:.1f}s ✓")
    return {"loss": loss, "probe_accuracy": acc,
            "silhouette": eco["silhouette"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps)
