"""Batch assembly and the host -> device prefetch: the port's counterpart of
``deepearth_tpu/data/batches.py``.

A plain Python producer assembles numpy batches (mmap-backed), and
:func:`device_prefetch` keeps up to ``size`` of them in flight to the card:
each leaf is copied into pinned host memory and sent with
``non_blocking=True`` on a copy stream of its own, so that the copy
overlaps the step that runs on the consumer's stream.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

SHARDING_TODO = ("device_prefetch(sharding=...) needs the multi-GPU slice, "
                 "which is not ported yet (ROADMAP.md Queue 1, item 15)")


def map_leaves(fn, tree):
    """``fn`` over every leaf of a batch tree (dicts, lists and tuples are
    nodes, with their structure kept)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a batch tree, in :func:`map_leaves` order."""
    out = []
    map_leaves(out.append, tree)
    return out


def _host_tensor(x, pin: bool):
    """A numpy or CPU torch leaf as a CPU tensor of its dtype: a fresh
    pinned copy with ``pin``, else the numpy buffer itself where it can be
    shared. Other leaves (Python scalars, strings) are returned as they
    are."""
    if isinstance(x, torch.Tensor):
        return x.pin_memory() if pin and not x.is_pinned() else x
    if not isinstance(x, (np.ndarray, np.generic)) or x.dtype.kind not in "biuf":
        return x
    x = np.asarray(x)
    if not pin:
        if not (x.flags.c_contiguous and x.flags.writeable):
            x = np.array(x)
        return torch.from_numpy(x)
    dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
    host = torch.empty(x.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = x
    return host


def device_prefetch(
    iterator: Iterable[Dict[str, Any]],
    size: int = 2,
    device=None,
    sharding: Optional[Any] = None,
) -> Iterator[Dict[str, Any]]:
    """Yield the batches of ``iterator`` as tensors on ``device`` (the card
    unless the caller asks for another), keeping up to ``size`` of them in
    flight.

    On the card: each numpy leaf is copied into a pinned host tensor and
    sent with ``non_blocking=True`` on a dedicated copy stream, followed by
    an event. Before a batch is handed over, the consumer's current stream
    waits on that event, and every device tensor of the batch is
    ``record_stream``-ed onto it, so the caching allocator does not reuse
    its memory while the consumer's work may still read it. Each pinned
    staging tensor stays referenced until its copy's event has completed.
    Integer and bool leaves keep their dtype; nested dicts keep their
    structure. On a CPU ``device`` the leaves become CPU tensors over the
    numpy buffers, and no stream is used.

    As the JAX package's prefetch: ``size`` batches are pulled before the
    first is yielded, and one more each time the consumer takes one.
    """
    if sharding is not None:
        raise NotImplementedError(SHARDING_TODO)
    device = torch.device("cuda" if device is None else device)
    it = iter(iterator)
    buf: collections.deque = collections.deque()

    if device.type == "cpu":
        def put(batch):
            return map_leaves(lambda x: _host_tensor(x, pin=False), batch)

        def hand_over(item):
            return item
        pending = None
    else:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copy_stream = torch.cuda.Stream(device)
        # (event, pinned staging tensors) of copies that may still run
        pending = collections.deque()

        def put(batch):
            while pending and pending[0][0].query():
                pending.popleft()
            staged = []

            def send(x):
                host = _host_tensor(x, pin=True)
                if not isinstance(host, torch.Tensor):
                    return host
                staged.append(host)
                return host.to(device, non_blocking=True)
            # the copies' device memory comes from the copy stream's pool,
            # which the consumer's freed tensors never join
            with torch.cuda.stream(copy_stream):
                out = map_leaves(send, batch)
                event = torch.cuda.Event()
                event.record(copy_stream)
            pending.append((event, staged))
            return out, event

        def hand_over(item):
            out, event = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(consumer)
            return out

    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    try:
        while buf:
            yield hand_over(buf.popleft())
            try:
                buf.append(put(next(it)))
            except StopIteration:
                pass
    finally:
        # the staging tensors are released only after their copies ran
        while pending:
            pending.popleft()[0].synchronize()


def echo_on_device(
    iterator: Iterable[Dict[str, Any]],
    factor: int,
) -> Iterator[Dict[str, Any]]:
    """Data echoing (Choi et al. 2019): yield each already-on-device batch
    ``factor`` times so link-bound pipelines amortize one host -> device
    copy over several optimizer steps.

    The masked-reconstruction objective re-randomizes which targets are
    hidden every step (the train step draws fresh masks), so echoed steps
    see different prediction problems over the same rows.

    Wrap AFTER :func:`device_prefetch` so the repeat reuses the device
    buffer (echoing before the copy would ship the same bytes again).
    """
    if factor < 1:
        raise ValueError(f"echo factor must be >= 1, got {factor}")
    for batch in iterator:
        for _ in range(factor):
            yield batch


def threaded_producer(
    make_iterator, capacity: int = 4
) -> Iterator[Dict[str, Any]]:
    """Run batch assembly in a background thread (the host-side analogue of
    DataLoader workers) so mmap reads overlap device compute. An exception
    in the worker is raised again in the consumer."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=capacity)
    _END = object()

    def worker():
        try:
            for item in make_iterator():
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate to the consumer, don't swallow
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def collate_observations(
    obs_list: Sequence[Dict[str, np.ndarray]],
    modalities: Sequence[str],
) -> Dict[str, Any]:
    """Stack per-observation dicts into one batch with the model schema
    (reference schema: dashboard/services/training_data.py:22-80)."""
    out: Dict[str, Any] = {
        "xyzt": np.stack([o["xyzt"] for o in obs_list]).astype(np.float32),
        "modalities": {},
    }
    for m in modalities:
        if m in obs_list[0]:
            out["modalities"][m] = np.stack([o[m] for o in obs_list])
    return out
