"""Async device feed: a producer thread, overlapped H2D copies, and
per-stage input-wait telemetry.

The twin of ``deepvision_tpu/data/prefetch.py``. A background producer
pulls host batches (dicts of numpy arrays), moves them to the device and
keeps up to ``depth`` of them queued ahead of the consumer:

- **deterministic order**: one producer and a FIFO queue;
- **bounded memory**: the producer blocks while ``depth`` batches wait;
- **exception propagation**: a producer exception is raised in the
  consumer at the failed batch;
- **clean shutdown**: :meth:`DevicePrefetcher.close` stops and joins the
  producer.

On a CUDA device the producer copies each host array into a ring of
pinned host buffers and issues ``non_blocking`` copies on a side stream;
an event recorded after them is what the consumer's stream waits on, and
each device tensor is marked with ``record_stream`` for the consumer's
stream, so that the allocator does not reuse its memory before the
consumer's work on it is done. A pinned buffer is refilled only after
its last copy's event has completed. On the CPU the producer only
converts and queues.

A packed batch (one with a ``decode(device)`` method, such as
``data/jpeg.py``'s JPEG batches) crosses as it is and is decoded by that
method on the side stream (on the CPU, in the producer); it names its
own image bytes, image count and wire (``image_bytes``, ``n_images``,
``wire_dtype``) for the byte accounting.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "FeedTelemetry"]


class FeedTelemetry:
    """Wall time of the feed's stages, in seconds, and the wire bytes.

    ``host_wait_s``: the producer blocked on the upstream iterator;
    ``shard_s``: the producer staging into pinned memory and issuing the
    copies; ``h2d_wait_s``: the consumer blocked on a ready batch;
    ``step_s``: the consumer's time between batches; ``h2d_bytes``: every
    array that crossed, of which ``h2d_image_bytes`` the images (uint8 or
    float32 pixels, or a packed batch's own ``image_bytes``). Each field
    has one writer thread."""

    def __init__(self):
        self.host_wait_s = 0.0
        self.shard_s = 0.0
        self.h2d_wait_s = 0.0
        self.step_s = 0.0
        self.batches = 0
        self.h2d_bytes = 0
        self.h2d_image_bytes = 0
        self.h2d_images = 0
        self.wire_dtype: str | None = None

    def record_wire(self, batch: dict) -> None:
        """Account one host batch about to cross the wire: the bytes of
        every array, the images (rows of every 4-D array), their bytes and
        their dtype; a packed batch names its own."""
        leaves = [v for v in batch.values() if hasattr(v, "nbytes")]
        if not leaves:
            return
        self.h2d_bytes += int(sum(v.nbytes for v in leaves))
        if _packed(batch):
            self.h2d_image_bytes += batch.image_bytes
            self.h2d_images += batch.n_images
            self.wire_dtype = batch.wire_dtype
            return
        images = [v for v in leaves if getattr(v, "ndim", 0) >= 4]
        images = images or leaves[:1]
        self.h2d_image_bytes += int(sum(v.nbytes for v in images))
        self.h2d_images += int(sum(len(v) for v in images))
        self.wire_dtype = str(images[0].dtype)

    @property
    def h2d_bytes_per_image(self) -> float:
        return self.h2d_bytes / self.h2d_images if self.h2d_images else 0.0

    @property
    def image_bytes_per_image(self) -> float:
        return (self.h2d_image_bytes / self.h2d_images
                if self.h2d_images else 0.0)

    def summary(self) -> dict:
        """Per-batch milliseconds of each stage, and ``wait_frac``, the
        consumer's share of time spent waiting on input."""
        n = max(1, self.batches)
        wait, busy = self.h2d_wait_s, self.step_s
        return {
            "batches": self.batches,
            "host_wait_ms": round(self.host_wait_s / n * 1e3, 3),
            "shard_ms": round(self.shard_s / n * 1e3, 3),
            "h2d_wait_ms": round(self.h2d_wait_s / n * 1e3, 3),
            "step_ms": round(self.step_s / n * 1e3, 3),
            "wait_frac": (round(wait / (wait + busy), 4)
                          if wait + busy > 0 else 0.0),
            "h2d_bytes_per_image": round(self.h2d_bytes_per_image, 1),
            "image_bytes_per_image": round(self.image_bytes_per_image, 1),
            "wire_dtype": self.wire_dtype,
        }


def _packed(batch) -> bool:
    """Whether ``batch`` is a packed batch, decoded on the device by its
    own ``decode``."""
    return callable(getattr(batch, "decode", None))


# queue item kinds (first tuple element)
_BATCH, _DONE, _ERROR = "batch", "done", "error"


class _PinnedRing:
    """``slots`` sets of pinned host buffers, one per batch key, reused
    in turn; a slot is refilled only after its copies' event completed."""

    def __init__(self, slots: int):
        self._bufs: list[dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._next = 0

    def stage(self, batch: dict, device: torch.device,
              stream: torch.cuda.Stream):
        """-> (device batch, event after its copies)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        bufs = self._bufs[i]
        out = {}
        with torch.cuda.stream(stream):
            for key, value in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(value))
                buf = bufs.get(key)
                if buf is None or buf.shape != host.shape \
                        or buf.dtype != host.dtype:
                    buf = bufs[key] = torch.empty(
                        host.shape, dtype=host.dtype, pin_memory=True)
                buf.copy_(host)
                out[key] = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self._events[i] = event
        return out, event


class DevicePrefetcher:
    """Iterator of device batches fed by a background thread; ``depth``
    ready batches are kept queued ahead of the consumer."""

    def __init__(self, batches: Iterable[dict], device: torch.device, *,
                 depth: int = 2, telemetry: FeedTelemetry | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self.telemetry = telemetry if telemetry is not None \
            else FeedTelemetry()
        self._src = iter(batches)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False
        self._last_yield: float | None = None
        self._ring = self._stream = None
        if self.device.type == "cuda":
            # the queued batches, the one the consumer holds and the one
            # being staged
            self._ring = _PinnedRing(depth + 2)
            self._stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(target=self._produce,
                                        name="device-prefetch", daemon=True)
        self._thread.start()

    # -- producer (background thread) -----------------------------------
    def _produce(self) -> None:
        tel = self.telemetry
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(self._src)
                except StopIteration:
                    self._put((_DONE, None))
                    return
                t1 = time.perf_counter()
                tel.host_wait_s += t1 - t0
                tel.record_wire(batch)
                item = self._to_device(batch)
                tel.shard_s += time.perf_counter() - t1
                if not self._put((_BATCH, item)):
                    return  # closed while waiting for queue space
        except BaseException as e:  # re-raised at the consumer's next pull
            self._put((_ERROR, e))

    def _to_device(self, batch: dict):
        if _packed(batch):
            if self._ring is None:
                return batch.decode(self.device), None
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                out = batch.decode(self.device)
                event = torch.cuda.Event()
                event.record(self._stream)
            return out, event
        if self._ring is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}, None
        with torch.cuda.device(self.device):
            return self._ring.stage(batch, self.device, self._stream)

    def _put(self, item) -> bool:
        """Backpressured enqueue that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer --------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter()
        if self._last_yield is not None:
            self.telemetry.step_s += t0 - self._last_yield
        kind, payload = self._q.get()
        self.telemetry.h2d_wait_s += time.perf_counter() - t0
        if kind is not _BATCH:
            self._finished = True
            self._last_yield = None
            if kind is _ERROR:
                raise payload
            raise StopIteration
        batch, event = payload
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        self.telemetry.batches += 1
        self._last_yield = time.perf_counter()
        return batch

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and join its thread. Idempotent."""
        self._finished = True
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
