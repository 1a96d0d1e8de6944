"""Shape-bucketed runner cache: build once a bucket, serve forever.

The port's own copy of ``deepvision_tpu/serve/compile_cache.py``, with
the same LRU, keys, counters and API, and :meth:`CompileCache.items`,
from which the engine reports its runners. Serving traffic arrives at any
batch size; the engine pads every micro-batch up to a fixed bucket
ladder and runs the runner of its ``(model, bucket, dtype, weights
fingerprint)`` key, all of them built at start-up
(``engine.InferenceEngine.warm``), so that no request pays a build. On
the card a runner is one captured CUDA graph (``ServedModel.compile_for``):
building it runs the forward eagerly once (cuDNN's algorithm choice, the
kernels' build) and captures it, which a request must never pay.

The cache is an LRU so that a long-lived multi-model host stays
bounded; with the default ladder (4 buckets x a few models) nothing is
ever evicted. Hit, miss and eviction counters feed ``stats()["cache"]``:
after the warm-up, ``misses`` must stay frozen (no request built a
runner), and :meth:`freeze` turns that into an error.

:meth:`CompileCache.install` and :meth:`CompileCache.drop_where` are the
deliberate mutation channel after the warm-up, and neither counts a
miss: a hot swap installs its new ladder and drops the old fingerprint's
runners, an eviction (``serve/tenancy.py``) drops the runners captured
over the evicted weights, and their recapture installs them again under
the same keys. The cache's :attr:`CompileCache.lock` is also the
residency lock of the engine's ``TenancyManager``, so that a build, its
registration and an eviction's drop happen in one order.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable

__all__ = ["CompileCache"]


class CompileCache:
    """LRU of built runners keyed by ``(model, bucket, dtype, weights
    fingerprint)``.

    ``build`` callables passed to :meth:`get_or_build` return the ready
    runner; the cache never inspects them. Builds run under the lock:
    they are only called from the engine's warm-up and its one
    dispatcher thread, and two concurrent builds of one key would both
    pay the capture.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._entries: OrderedDict[Hashable, Callable] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._frozen = False

    @property
    def lock(self) -> threading.RLock:
        """The cache's reentrant lock, held by every method and by a
        build."""
        return self._lock

    def freeze(self) -> None:
        """Turn "misses stay frozen after the warm-up" from a telemetry
        tripwire into a guarantee: any later miss raises instead of
        building. A request that reaches a cold key is a warm-up
        coverage bug, and paying the build quietly would hide it as tail
        latency."""
        with self._lock:
            self._frozen = True

    def get_or_build(self, key: Hashable, build: Callable[[], Callable]):
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            if self._frozen:
                raise RuntimeError(
                    f"compile cache is frozen after warmup but key "
                    f"{key!r} missed — a request would have paid a "
                    "hidden build (warmup coverage bug)")
            self.misses += 1
            runner = build()
            self._entries[key] = runner
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
            return runner

    def install(self, key: Hashable, runner: Callable) -> None:
        """Insert a ready runner, bypassing the miss path. It works on a
        frozen cache and counts as neither hit nor miss, so that the
        miss tripwire keeps meaning "a request paid a build"."""
        with self._lock:
            self._entries[key] = runner
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def drop_where(self, pred: Callable[[Hashable], bool]) -> int:
        """Remove the entries whose key satisfies ``pred``; returns how
        many. Not counted as LRU evictions."""
        with self._lock:
            stale = [k for k in self._entries if pred(k)]
            for k in stale:
                del self._entries[k]
            return len(stale)

    def items(self) -> list[tuple[Hashable, Callable]]:
        """The ``(key, runner)`` pairs held now, least recently used
        first."""
        with self._lock:
            return list(self._entries.items())

    def contains(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "frozen": self._frozen,
            }
