"""Command-line entry points of the PyTorch port, the counterparts of the
JAX package's ``scripts/train.py``, ``scripts/serve.py``,
``scripts/prepare_data.py``, ``scripts/convert_checkpoint.py`` and
``scripts/generate_cli.py``:

    python -m deepearth_tpu_torch.cli.train --steps 500 --batch-size 64 \\
        --checkpoint-dir ckpts/
    python -m deepearth_tpu_torch.cli.serve --with-predictor --port 8080
    python -m deepearth_tpu_torch.cli.prepare_data --input emb.parquet \\
        --shape 576 1408 --output /data/vision
    python -m deepearth_tpu_torch.cli.convert_checkpoint hf_ckpt/ out/ \\
        --verify
    python -m deepearth_tpu_torch.cli.generate out/ --prompt "live oak"

Each module has a ``main(argv=None)``. ``train``, ``serve``, ``generate``
and ``convert_checkpoint --verify`` run on the card unless given
``--device cpu``.
"""
