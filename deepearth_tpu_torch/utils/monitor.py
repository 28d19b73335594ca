"""Resource monitoring during training, PyTorch port of
``deepearth_tpu/utils/monitor.py``
(reference: monitor_training.py:12-44, train_deepearth.py:119-142 —
GPU/CPU/RAM/net stats logged to wandb; here: psutil + the cards' allocator
statistics, logged through the metric writers).

``psutil`` is imported when a snapshot is taken, so the module (and
``utils``) imports on a machine without it.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch


def resource_snapshot() -> Dict[str, float]:
    """Instantaneous host + device resource metrics. Device keys as JAX
    gives them (``device{i}/bytes_in_use_gb``, ``device{i}/peak_bytes_gb``)
    from ``torch.cuda.memory_stats`` of each card; none without a card."""
    import psutil

    vm = psutil.virtual_memory()
    out = {
        "sys/cpu_percent": psutil.cpu_percent(interval=None),
        "sys/ram_used_gb": vm.used / 1e9,
        "sys/ram_percent": vm.percent,
    }
    try:
        net = psutil.net_io_counters()
        out["sys/net_sent_gb"] = net.bytes_sent / 1e9
        out["sys/net_recv_gb"] = net.bytes_recv / 1e9
    except Exception:
        pass
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if stats:
                out[f"device{i}/bytes_in_use_gb"] = (
                    stats.get("allocated_bytes.all.current", 0) / 1e9
                )
                out[f"device{i}/peak_bytes_gb"] = (
                    stats.get("allocated_bytes.all.peak", 0) / 1e9
                )
    return out


class ResourceMonitor:
    """Background thread sampling resources every ``interval`` seconds and
    forwarding them to a callback (e.g. a metric writer's log)."""

    def __init__(
        self,
        callback: Callable[[Dict[str, float]], None],
        interval: float = 30.0,
    ):
        self.callback = callback
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ResourceMonitor":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.callback(resource_snapshot())
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
