"""Device time of one kernel call on a CUDA card, L2-cold or warm.

``chip_smoke.py`` and ``lrn_ab.py`` time kernels with these functions,
so that their numbers compare. This module imports only torch and the
standard library: ``lrn_ab.py`` loads it by path beside another
checkout's package.
"""

from __future__ import annotations

import functools
import statistics
import time

import torch

__all__ = ["COLD_INPUT_BYTES", "cold_inputs", "time_ms"]

# distinct inputs a cold timing cycles through: twice an H100's 50 MB L2
COLD_INPUT_BYTES = 100e6


@functools.cache
def _spin_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def _hold_device(ms: float) -> None:
    """Keep the current stream busy for about ``ms`` (a spin kernel), so
    that the launches the host queues meanwhile run back to back."""
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms()))


def cold_inputs(shape, dtype: torch.dtype,
                gen: torch.Generator) -> list[torch.Tensor]:
    """Standard-normal inputs of ``shape`` on the card, as many distinct
    buffers (at least 2) as make ``COLD_INPUT_BYTES``, so that a timing
    that cycles through them misses L2 on every call."""
    nbytes = torch.Size(shape).numel() * torch.finfo(dtype).bits // 8
    n_bufs = max(2, -(-int(COLD_INPUT_BYTES) // nbytes))
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(n_bufs)]


def time_ms(fn, inputs, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of one call ``fn(x)``, from CUDA events around
    each, cycling through ``inputs``: L2-cold with ``cold_inputs``, warm
    with a single buffer. The device is held busy while the host queues
    the timed calls, so that the host's launch time (tens of microseconds
    a call, as long as the kernel itself) is not counted. The outputs
    stay alive until their input comes round again, so that distinct
    inputs also mean distinct outputs."""
    outs = [None] * len(inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        outs[i % len(inputs)] = fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    _hold_device(2 * iters * host_ms + 1)
    for i, (start, end) in enumerate(events):
        j = i % len(inputs)
        start.record()
        outs[j] = fn(inputs[j])
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
