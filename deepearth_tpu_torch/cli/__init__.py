"""Command-line entry points of the PyTorch port, the counterparts of the
JAX package's ``scripts/train.py``, ``scripts/serve.py``,
``scripts/prepare_data.py``, ``scripts/convert_checkpoint.py``,
``scripts/generate_cli.py`` and ``scripts/extract_parallel.py``:

    python -m deepearth_tpu_torch.cli.train --steps 500 --batch-size 64 \\
        --checkpoint-dir ckpts/
    python -m deepearth_tpu_torch.cli.serve --with-predictor --port 8080
    python -m deepearth_tpu_torch.cli.prepare_data --input emb.parquet \\
        --shape 576 1408 --output /data/vision
    python -m deepearth_tpu_torch.cli.convert_checkpoint hf_ckpt/ out/ \\
        --verify
    python -m deepearth_tpu_torch.cli.generate out/ --prompt "live oak"
    python -m deepearth_tpu_torch.cli.extract_parallel extract \
        --items items.txt --out-dir chunks/ --shard-id 0 --num-shards 1
    python -m deepearth_tpu_torch.cli.extract_parallel merge \
        --out-dir chunks/ --store /data/vision

Each module has a ``main(argv=None)``. ``train``, ``serve``, ``generate``,
``convert_checkpoint --verify`` and a backbone of ``extract_parallel`` run
on the card unless given ``--device cpu``.
"""
