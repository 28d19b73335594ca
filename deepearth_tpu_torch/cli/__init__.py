"""Command-line entry points of the PyTorch port, the counterparts of the
JAX package's ``scripts/train.py``, ``scripts/serve.py`` and
``scripts/prepare_data.py``:

    python -m deepearth_tpu_torch.cli.train --steps 500 --batch-size 64 \\
        --checkpoint-dir ckpts/
    python -m deepearth_tpu_torch.cli.serve --with-predictor --port 8080
    python -m deepearth_tpu_torch.cli.prepare_data --input emb.parquet \\
        --shape 576 1408 --output /data/vision

Each module has a ``main(argv=None)``. ``train`` and ``serve`` run on the
card unless given ``--device cpu``.
"""
