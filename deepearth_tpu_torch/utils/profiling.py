"""Profiling and benchmark helpers, PyTorch port of
``deepearth_tpu/utils/profiling.py``.

The reference had only wall-clock timing scattered through benchmarks
(reference: tests/run_tests.py:264-329, dashboard/mmap_embedding_loader.py
stats). Here: ``torch.profiler`` traces plus a reusable latency/throughput
harness that keeps the reference's "samples/sec + ms/sample" report format.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the host and, with a card, the device;
    on exit the Chrome trace is written into ``log_dir``
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def benchmark_fn(
    fn: Callable[[], Any],
    iters: int = 100,
    warmup: int = 10,
    samples_per_call: int = 1,
) -> Dict[str, float]:
    """Latency/throughput harness (reference: tests/run_tests.py:264-329).

    Each call is timed to the end of its device work: where ``fn`` returns
    CUDA tensors (alone or inside tuples, lists and dicts) the card is
    synchronised before the clock stops.
    """
    out = None
    for _ in range(warmup):
        out = fn()
    if out is not None:
        _block(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        _block(out)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    total = times.sum()
    return {
        "iters": iters,
        "samples_per_sec": samples_per_call * iters / total,
        "ms_per_sample": 1000.0 * total / (iters * samples_per_call),
        "p50_ms": float(np.percentile(times, 50) * 1000),
        "p90_ms": float(np.percentile(times, 90) * 1000),
        "p99_ms": float(np.percentile(times, 99) * 1000),
    }


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block(out) -> None:
    """Wait for the device work behind ``out``: synchronise every card its
    tensors lie on (JAX's ``block_until_ready``)."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


class StepTimer:
    """Per-step timing accumulator for training loops."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._times = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1000),
            "p50_ms": float(np.percentile(t, 50) * 1000),
        }
