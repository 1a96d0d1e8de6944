"""Sharded TFRecord writing, the twin of
``deepvision_tpu/data/builders/shard_writer.py``.

Item ``j`` of ``items`` goes to shard ``j % num_shards`` (the JAX
``items[i::num_shards]``), the shards named ``<split>-00012-of-01024``;
with ``num_workers`` > 1 the shards are written by a ``spawn`` pool.
Spawn, not the platform's fork: builders run in processes that already
started threads (torch's, a CUDA context, a test runner's), and a forked
child inherits their held locks with no thread to release them; the JAX
suite wedged on exactly that. Spawned workers start from a clean
interpreter, so the feature function and the items must be picklable
(module-level functions, ``functools.partial`` of them, plain classes).

Where the JAX writer drops an item whose feature function fails, the
port's names it: the feature function raises (or returns None) and the
item is left out, counted and reported with its reason in the summary
line :func:`write_sharded` prints to stderr (with the seconds the build
took, the spawn pool's start included); the records written are the
return value, as in JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import time
from pathlib import Path
from typing import Callable, Sequence

from deepvision_tpu_torch.data.tfrecord import encode_example, write_records

__all__ = ["shard_name", "item_name", "write_sharded"]


def shard_name(output_dir: str | Path, split: str, idx: int,
               total: int) -> Path:
    return Path(output_dir) / f"{split}-{idx:05d}-of-{total:05d}"


def item_name(item, index: int) -> str:
    """A name to report an item by: its path (a path, or the first path
    of a tuple, or a dict's ``image_path``), else its index."""
    if isinstance(item, tuple) and item:
        item = item[0]
    if isinstance(item, dict) and "image_path" in item:
        item = item["image_path"]
    if isinstance(item, (str, Path)):
        return str(item)
    return f"item {index}"


def _write_one_shard(args) -> tuple[int, list[tuple[str, str]]]:
    make_features, items, path, first, stride = args
    records, skipped = [], []
    for k, item in enumerate(items):
        try:
            feats = make_features(item)
            if feats is None:
                raise ValueError("no features")
        except Exception as e:  # the item is reported, not fatal
            skipped.append((item_name(item, first + k * stride),
                            f"{type(e).__name__}: {e}"))
            continue
        records.append(encode_example(feats))
    write_records(path, records)
    return len(records), skipped


def write_sharded(items: Sequence, make_features: Callable,
                  output_dir: str | Path, split: str, *, num_shards: int,
                  num_workers: int = 8) -> int:
    """Distribute ``items`` over ``num_shards`` files; returns the records
    written. ``make_features(item) -> dict`` runs in the worker process;
    an item it fails on is left out and named, with its reason, on the
    summary line printed to stderr."""
    t0 = time.perf_counter()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    chunks = [(make_features, items[i::num_shards],
               shard_name(output_dir, split, i, num_shards), i, num_shards)
              for i in range(num_shards)]
    if num_workers > 1:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(_write_one_shard, chunks)
    else:
        results = [_write_one_shard(c) for c in chunks]
    written = sum(n for n, _ in results)
    skipped = [s for _, ss in results for s in ss]
    line = (f"[build] {split}: {written} records in {num_shards} shards "
            f"in {time.perf_counter() - t0:.3f} s")
    if skipped:
        line += f"; skipped {len(skipped)}: " + "; ".join(
            f"{name} ({reason})" for name, reason in skipped)
    print(line, file=sys.stderr, flush=True)
    return written
