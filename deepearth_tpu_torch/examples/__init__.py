"""The examples of the PyTorch port, counterparts of the repository's
``examples/``: ``quick_test`` (the tiny masked-reconstruction model),
``density_field`` (Grid4D + MLP density regression) and
``florida_pipeline`` (storage, splits, training and evaluation end to end).
Each runs as ``python -m deepearth_tpu_torch.examples.<name>`` on the card,
or with ``--device cpu``."""
