"""The port's multi-process host loader (``data/loader.py``) on the CPU.

Held against ``deepvision_tpu/data/loader.py``: the round-robin merged
order over a numpy-only picklable factory with 2 workers, and the order
after a ``worker_kill`` respawn (equal to the undisturbed run's on both
sides). Port-only: spawn after a thread pool in the parent (trap C24),
a worker's exception raised with its traceback, the bounded respawn
giving up, the pickled path for a batch that outgrows its slot (counted
and named), ``make_imagenet_data(loader_workers=2)`` over test-written
JPEG and raw-crop shards (file shards composed per worker, JPEG batches
decoded by the parent), and the training CLI's ``--loader-workers``,
with a killed worker respawned, and its refusals.
"""

import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deepvision_tpu.data import loader as jax_loader
from deepvision_tpu.resilience import FaultInjector as JaxFaultInjector
from deepvision_tpu_torch.data.imagenet import (
    TrainShardFactory,
    make_imagenet_data,
)
from deepvision_tpu_torch.data.jpeg import PackedJpegBatch
from deepvision_tpu_torch.data.loader import (
    MultiProcessLoader,
    WorkerError,
    mp_batches,
)
from deepvision_tpu_torch.obs.metrics import default_registry
from deepvision_tpu_torch.resilience import FaultInjector
from deepvision_tpu_torch.train.__main__ import main as train_main
from tests.torch_loader_factory import (
    FailingFactory,
    GrowingFactory,
    NumpyShardFactory,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


# every wait on the workers is bounded: past it the loader is closed,
# its iteration ends, and the test fails on what it got instead of hanging
WAIT_S = 120


def _bounded(loader):
    timer = threading.Timer(WAIT_S, loader.close)
    timer.daemon = True
    timer.start()
    return timer


def _drain(loader_cls, *args, **kw):
    with loader_cls(*args, **kw) as loader:
        timer = _bounded(loader)
        try:
            return [{k: v.copy() for k, v in b.items()} for b in loader]
        finally:
            timer.cancel()


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_merged_order_equals_jax():
    factory = NumpyShardFactory(batches=5)
    got = _drain(MultiProcessLoader, factory, 2)
    want = _drain(jax_loader.MultiProcessLoader, factory, 2)
    _assert_same(got, want)
    # round-robin: w0, w1, w0, ...
    assert [int(b["w"][0]) for b in got] == [0, 1] * 5


def test_order_after_a_worker_kill_equals_jax_and_the_undisturbed_run(
        capsys):
    factory = NumpyShardFactory(batches=5)
    undisturbed = _drain(MultiProcessLoader, factory, 2)
    got = _drain(MultiProcessLoader, factory, 2, max_restarts=2,
                 fault_injector=FaultInjector("wkill@3"))
    want = _drain(jax_loader.MultiProcessLoader, factory, 2, max_restarts=2,
                  fault_injector=JaxFaultInjector("wkill@3"))
    _assert_same(got, undisturbed)
    _assert_same(want, undisturbed)
    out = capsys.readouterr().out
    assert out.count("[fault] SIGKILLing loader worker 1") == 2
    assert out.count("[loader] worker 1 died") == 2
    assert "(restart 1/2)" in out


def test_spawns_after_a_thread_pool_in_the_parent():
    """Trap C24: threads running in the parent (a pool, the device feed)
    would hand a forked child their held locks; the loader spawns."""
    gate = threading.Event()
    with ThreadPoolExecutor(4) as pool:
        busy = [pool.submit(gate.wait, 30) for _ in range(4)]
        loader = MultiProcessLoader(NumpyShardFactory(batches=2), 2)
        timer = _bounded(loader)
        try:
            assert loader._ctx.get_start_method() == "spawn"
            got = list(loader)
        finally:
            timer.cancel()
            loader.close()
            gate.set()
        assert all(f.result() for f in busy)
    assert len(got) == 4 and loader.paths == {"shm": 4, "pickle": 0}


def test_a_worker_exception_is_raised_with_its_traceback():
    loader = MultiProcessLoader(FailingFactory(good=2, worker=1), 2)
    timer = _bounded(loader)
    got = []
    with pytest.raises(WorkerError) as err:
        for b in loader:
            got.append(b)
    timer.cancel()
    loader.close(timeout=5)
    assert len(got) == 5  # w0 b0, w1 b0, w0 b1, w1 b1, w0 b2; then w1
    assert "loader worker 1/2 died" in str(err.value)
    assert "ValueError: bad shard in worker 1" in str(err.value)


def test_bounded_respawn_gives_up_on_a_persistent_fault(capsys):
    before = default_registry().value_of("loader_worker_restarts")
    with pytest.raises(WorkerError, match="gave up after 2 consecutive"):
        _drain(MultiProcessLoader, FailingFactory(good=0, worker=0), 1,
               max_restarts=2)
    assert default_registry().value_of("loader_worker_restarts") \
        == before + 2
    assert "(restart 2/2)" in capsys.readouterr().out


def test_a_batch_that_outgrows_its_slot_crosses_pickled():
    before = default_registry().value_of("loader_pickle_batches")
    with MultiProcessLoader(GrowingFactory(), 2) as loader:
        timer = _bounded(loader)
        got = list(loader)
        timer.cancel()
        paths = dict(loader.paths)
    assert [b["x"].shape[0] for b in got] == [2, 2, 8, 8, 8, 8]
    assert paths == {"shm": 2, "pickle": 4}
    assert default_registry().value_of("loader_pickle_batches") \
        == before + 4


def test_mp_batches_closes_the_pool_at_a_break():
    gen = mp_batches(NumpyShardFactory(batches=50), 2, limit=3)
    assert len(list(gen)) == 3  # the finally stopped and joined them


# ------------------------------------------------------- the records


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_imagenet,
    )

    d = tmp_path_factory.mktemp("loader_records")
    write_synthetic_imagenet(d, train=48, val=8, raw=48, classes=5,
                             shards=4, jpeg_sizes=(72, 96), stored=80,
                             device="cpu")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("use_raw", [False, True])
def test_imagenet_reader_over_two_workers(records, use_raw):
    train, _, steps = make_imagenet_data(
        str(records), 4, 64, use_raw=use_raw, steps_per_epoch=6,
        loader_workers=2, shuffle_buffer=8)
    first = list(train(0))
    again = list(train(0))
    assert len(first) == steps == 6
    for a, b in zip(first, again):  # the merged order is deterministic
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if use_raw:
        assert first[0]["image"].shape == (4, 64, 64, 3)
        assert first[0]["image"].dtype == np.uint8
    else:
        assert all(isinstance(b, PackedJpegBatch) for b in first)
        out = first[0].decode(torch.device("cpu"))
        assert out["image"].shape == (4, 64, 64, 3)
        assert out["image"].dtype == torch.uint8
        assert first[0].plan.crop_u.shape == (4, 2)


def test_train_shard_factory_composes_the_file_shards(records):
    files = sorted(records.glob("train-*"))
    factory = TrainShardFactory(
        kind="jpeg", files=files, batch_size=2, size=64, augment="tf",
        seed=0, device_aug=True, base_shards=2, base_index=1,
        shuffle_buffer=4)
    # worker w of 2 under process 1 of 2 reads shard 2 + w of 4: one file
    labels = []
    for w in (0, 1):
        batch = PackedJpegBatch.from_wire(next(iter(factory(w, 2))))
        assert batch.plan.flips is None  # device_aug: the crop only
        labels.append(batch["label"])
    assert all(len(x) == 2 for x in labels)


def test_cli_respawns_a_killed_worker(records, tmp_path, capsys):
    common = ["-m", "alexnet1", "--device", "cpu", "--data-dir",
              str(records), "--input-size", "64", "--num-classes", "5",
              "--batch-size", "4", "--steps-per-epoch", "4", "--epochs",
              "1", "--no-raw", "--workdir", str(tmp_path)]
    # the first turn: the worker has made nothing yet, so its death is
    # always seen (a later turn may find its share already queued)
    assert train_main([*common, "--loader-workers", "2", "--faults",
                       "wkill@0"]) == 0
    out = capsys.readouterr().out
    assert "[fault] SIGKILLing loader worker 0" in out
    assert re.search(r"\[loader\] worker 0 died .* respawning at shard "
                     r"position 0 \(restart 1/2\)", out)
    assert re.search(r"\[feed\] epoch 0: wire jpeg, .*; loader workers "
                     r"moved 4 batches through shared memory and 0 "
                     r"pickled", out), out
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("flags,message", [
    (["--loader-workers", "2"], "--data-dir ImageNet configs only"),
    (["--loader-workers", "0"], "--loader-workers must be >= 1"),
    (["--max-worker-restarts", "-1"], "--max-worker-restarts must be"),
])
def test_cli_refuses_loader_flags_as_train_py(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        train_main(["-m", "alexnet1", "--device", "cpu", "--workdir",
                    str(tmp_path), *flags])
