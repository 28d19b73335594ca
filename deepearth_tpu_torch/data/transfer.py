"""Int8-compressed host -> device batch transfer: the port's counterpart of
``deepearth_tpu/data/transfer.py``.

The float payload of a real batch is embedding data (V-JEPA2 patches,
language vectors), which tolerates 8-bit row quantization. So a batch can
cross the host -> device link as int8 and be dequantized on the card:

* host side: symmetric per-row int8 (scale = max|row| / 127, fp16 scales),
  2x fewer bytes than float16 and 4x fewer than float32; numpy, bit for bit
  the JAX module's;
* device side: an upcast and a multiply by the scale in the model's compute
  dtype, two elementwise torch ops on the card (XLA elementwise work in the
  JAX package, not a Pallas kernel).

Whether this pays over pinned PCIe on an H100 is measured by
``chip_smoke.py`` phase 20 (PERF.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .batches import device_prefetch, leaves

# marker keys: a compressed leaf is a dict {_Q: int8 values, _SCALE: f16}
_Q = "_int8_q"
_SCALE = "_int8_scale"


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization over the LAST axis.

    Returns (int8 values, float16 scales with shape x.shape[:-1] + (1,)).
    Row scale = max|row|/127; zero rows get scale 1 (encode to zeros).
    """
    x = np.asarray(x)
    amax = np.abs(x).max(axis=-1, keepdims=True).astype(np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float16)


def compress_batch(
    batch: Dict[str, Any], keys: Sequence[str]
) -> Dict[str, Any]:
    """Replace ``batch['modalities'][k]`` float arrays (k in keys) with
    int8 payload + scale leaves. Non-float and absent keys pass through."""
    out = dict(batch)
    mods = dict(batch.get("modalities", {}))
    for k in keys:
        v = mods.get(k)
        if v is None or not np.issubdtype(np.asarray(v).dtype, np.floating):
            continue
        q, scale = quantize_rows(v)
        mods[k] = {_Q: q, _SCALE: scale}
    out["modalities"] = mods
    return out


def _is_compressed(leaf) -> bool:
    return isinstance(leaf, dict) and _Q in leaf and _SCALE in leaf


def decompress_on_device(
    batch: Dict[str, Any], dtype=torch.bfloat16
) -> Dict[str, Any]:
    """Dequantize the compressed leaves of a batch of tensors where they
    lie: ``q.to(dtype) * scale.to(dtype)``."""
    out = dict(batch)
    mods = dict(batch.get("modalities", {}))
    for k, v in mods.items():
        if _is_compressed(v):
            mods[k] = v[_Q].to(dtype) * v[_SCALE].to(dtype)
    out["modalities"] = mods
    return out


def device_prefetch_compressed(
    iterator,
    keys: Sequence[str] = ("vision", "language"),
    size: int = 2,
    device=None,
    sharding: Optional[Any] = None,
    dtype=torch.bfloat16,
):
    """:func:`~.batches.device_prefetch` that ships the ``keys`` modalities
    as int8 over the host -> device link and yields dequantized batches
    (the dequantization runs on the consumer's stream, after the copy's
    event)."""
    compressed = (compress_batch(b, keys) for b in iterator)
    for dev_batch in device_prefetch(compressed, size=size, device=device,
                                     sharding=sharding):
        yield decompress_on_device(dev_batch, dtype=dtype)


def compressed_bytes(batch: Dict[str, Any]) -> int:
    """Total payload bytes of a (possibly compressed) batch tree."""
    total = 0
    for leaf in leaves(batch):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total
