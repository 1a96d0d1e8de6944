"""A numpy-only, picklable batch factory for the loader tests: the
spawned workers of both the port's and the JAX package's
``MultiProcessLoader`` import it afresh."""

import numpy as np


class NumpyShardFactory:
    """Worker ``w`` of ``n`` yields ``batches`` batches of its own seeded
    stream: ``{"x": uint8 (rows, 8, 8, 3), "y": int32 (rows,), "w":
    int32 (rows,)}``, the last tagging the worker."""

    def __init__(self, batches: int = 6, rows: int = 4, seed: int = 0):
        self.batches = batches
        self.rows = rows
        self.seed = seed

    def __call__(self, worker_id: int, num_workers: int):
        rng = np.random.default_rng([self.seed, worker_id, num_workers])
        for _ in range(self.batches):
            yield {"x": rng.integers(0, 256, (self.rows, 8, 8, 3),
                                     dtype=np.uint8),
                   "y": rng.integers(0, 10, self.rows).astype(np.int32),
                   "w": np.full(self.rows, worker_id, np.int32)}


class FailingFactory:
    """Yields ``good`` batches of ``NumpyShardFactory``, then raises in
    worker ``worker`` (every worker when None)."""

    def __init__(self, good: int = 2, worker: int | None = 1):
        self.good = good
        self.worker = worker

    def __call__(self, worker_id: int, num_workers: int):
        for i, batch in enumerate(NumpyShardFactory()(worker_id,
                                                      num_workers)):
            if i == self.good and self.worker in (None, worker_id):
                raise ValueError(f"bad shard in worker {worker_id}")
            yield batch


class GrowingFactory:
    """Batches whose rows grow 4x after the first: the later ones outgrow
    their ring slot and cross pickled."""

    def __call__(self, worker_id: int, num_workers: int):
        for rows in (2, 8, 8):
            yield {"x": np.full((rows, 16, 16, 3), worker_id, np.uint8)}
