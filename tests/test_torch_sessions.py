"""The port's stateful streams (``deepvision_tpu_torch/serve/sessions.py``,
the engine's stateful path, the router's session routing, the CLI's
``--track``) against the JAX package's, on the CPU.

- The ten store scenarios of ``tests/test_sessions.py``, each one script
  driven through the JAX ``SessionStore`` (numpy rows) and the port's
  (the same rows as tensors): the same dispositions, counters, snapshot
  files and stats.
- Snapshot files: the port's bytes for a (sid, seq, row) equal JAX's, and
  each package restores the other's bit for bit.
- The slate math, ``_track_update`` and ``_track_advance``, against JAX's
  on seeded slates and detections with duplicate scores, equal
  distances, all-invalid rows and an empty previous slate: bools, scores
  and ages (which a wrong selected or matched index would change) exact,
  boxes and velocities within 1e-6.
- ``synthetic_detector`` against JAX's within 1e-6, ``valid`` exact.
- The four engine scenarios of ``tests/test_sessions.py`` on both engines
  over the same frames (``detected``, ``state_reset``, ``tracked``
  exact, boxes and scores within 1e-6), the committed state a clone of
  the program's static output (the clone trap), and the two fault sites.
- Session routing over ``EngineReplica`` fleets: a kill survived in
  order and without a reset, each frame's answer the JAX engine's; FIFO
  a stream; the crc32 pins JAX's; a reset declared by a replayed frame
  passed on; a session on a stateless model refused.
- The CLI, the twin of ``make stream-smoke``: ``--fleet 2 --track
  synth:4 --buckets 4 --snapshot-every 3 --faults replica_kill@20
  --device cpu`` over 48 frames of 4 streams.

The synthetic detector (16x16x1 frames, 8 candidates, 4 slots) at bucket
4 keeps every run small.
"""

import contextlib
import io
import json
import re
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deepvision_tpu.serve import sessions as jax_sessions  # noqa: E402
from deepvision_tpu.serve import ShedError as JaxShedError  # noqa: E402
from deepvision_tpu_torch.resilience.faults import FaultInjector  # noqa: E402
from deepvision_tpu_torch.serve import ShedError  # noqa: E402
from deepvision_tpu_torch.serve import sessions  # noqa: E402
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)

TOL = 1e-6
SLOTS = 4


def wait_until(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------- the store, twice


def _state_row(rng, slots=SLOTS):
    return {
        "boxes": rng.normal(size=(slots, 4)).astype(np.float32),
        "velocity": rng.normal(size=(slots, 4)).astype(np.float32),
        "scores": rng.uniform(size=(slots,)).astype(np.float32),
        "age": rng.integers(0, 9, size=(slots,)).astype(np.float32),
    }


class _Side:
    """One package's store class, its shed error, and how its engine
    holds a state row (JAX: arrays; the port: tensors)."""

    def __init__(self, mod, shed, to_row):
        self.mod, self.shed, self.to_row = mod, shed, to_row


SIDES = {
    "jax": _Side(jax_sessions, JaxShedError, lambda row: row),
    "port": _Side(sessions, ShedError,
                  lambda row: {k: torch.from_numpy(v.copy())
                               for k, v in row.items()}),
}


def _frame(f):
    return (f.action, f.reset, f.restored, f.run_detect)


def _drive(side, store, sid, seqs, rng, log, detect_every=4):
    store.admit(sid)
    for seq in seqs:
        f = store.begin_frame(sid, seq, detect_every)
        log.append((sid, seq, *_frame(f)))
        if f.action == "apply":
            store.commit(sid, seq, side.to_row(_state_row(rng)))


def _snaps(d: Path, pattern="*") -> list[str]:
    return sorted(p.name for p in d.glob(pattern))


def _store_round_trip(side, d, log):
    rng = np.random.default_rng(0)
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=10)
    _drive(side, store, "s1", range(3), rng, log)
    log.append(store.flush())
    (snap,) = d.glob("s1-*.snap.json")
    log.append(side.mod.SessionStore.verify_snapshot(snap))
    seq, host = side.mod.SessionStore.load_snapshot(snap)
    rng = np.random.default_rng(0)
    want = [_state_row(rng) for _ in range(3)][-1]
    log.append((seq, sorted(host), all(
        host[k].dtype == want[k].dtype and host[k].tobytes() ==
        want[k].tobytes() for k in want)))


def _store_cadence(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2,
                                  keep_snapshots=2)
    _drive(side, store, "s1", range(9), np.random.default_rng(1), log)
    log.append((_snaps(d), store.stats()["counters"]))


def _store_restore(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2)
    _drive(side, store, "s1", range(4), np.random.default_rng(2), log)
    store.flush()
    store2 = side.mod.SessionStore(snapshot_dir=d)
    store2.admit("s1")
    log.append(_frame(store2.begin_frame("s1", 4, 4)))
    log.append(_frame(store2.begin_frame("s1", 3, 4)))
    log.append(store2.stats()["counters"])


def _store_corrupt_fallback(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2,
                                  keep_snapshots=2)
    _drive(side, store, "s1", range(6), np.random.default_rng(3), log)
    snaps = sorted(d.glob("s1-*.snap.json"))
    snaps[-1].write_bytes(b"\x00garbage\x00")
    store2 = side.mod.SessionStore(snapshot_dir=d)
    store2.admit("s1")
    log.append(_frame(store2.begin_frame("s1", 6, 4)))
    log.append((store2.stats()["counters"], _snaps(d)))


def _store_all_corrupt(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2,
                                  keep_snapshots=1)
    _drive(side, store, "s1", range(4), np.random.default_rng(4), log)
    for p in d.glob("s1-*.snap.json"):
        p.write_bytes(b"nope")
    store2 = side.mod.SessionStore(snapshot_dir=d)
    store2.admit("s1")
    log.append(_frame(store2.begin_frame("s1", 4, 4)))
    log.append(store2.stats()["counters"])


def _store_capacity(side, d, log):
    rng = np.random.default_rng(5)
    store = side.mod.SessionStore(capacity=2, ttl_s=300.0, snapshot_dir=d)
    _drive(side, store, "a", range(2), rng, log)
    _drive(side, store, "b", range(2), rng, log)
    try:
        store.admit("c")
    except side.shed as e:
        log.append(("shed", e.retry_after_s))
    st = store.stats()
    log.append((st["live"], st["counters"]))
    store.admit("a")  # an existing session is still admitted at capacity
    log.append(store.stats()["live"])


def _store_ttl(side, d, log):
    rng = np.random.default_rng(6)
    store = side.mod.SessionStore(capacity=2, ttl_s=10.0, snapshot_dir=d,
                                  snapshot_every=100)
    _drive(side, store, "a", range(3), rng, log)
    _drive(side, store, "b", range(1), rng, log)
    clock = {"t": store._now()}
    store._now = lambda: clock["t"]
    clock["t"] += 11.0  # both idle past the TTL
    store.admit("c")  # the eviction runs first: not shed
    st = store.stats()
    log.append((st["live"], st["counters"], _snaps(d)))
    log.append(_frame(store.begin_frame("a", 3, 4)))


def _store_gap(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d)
    _drive(side, store, "s", range(2), np.random.default_rng(7), log)
    log.append(_frame(store.begin_frame("s", 1, 4)))
    log.append(_frame(store.begin_frame("s", 5, 4)))
    log.append(store.stats()["counters"])


def _store_abandon(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2)
    _drive(side, store, "s", range(4), np.random.default_rng(8), log)
    before = _snaps(d)
    store.abandon()
    log.append((before, store.stats()["live"], _snaps(d)))


def _store_pinned(side, d, log):
    store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=2)
    log.append((store.pinned_bytes(), store.snapshot_age_s()))
    _drive(side, store, "s", range(3), np.random.default_rng(9), log)
    log.append((store.pinned_bytes(), store.snapshot_age_s() is not None))


STORE_SCENARIOS = {
    "round_trip": _store_round_trip,
    "cadence_and_pruning": _store_cadence,
    "restore_without_reset": _store_restore,
    "corrupt_quarantined_with_fallback": _store_corrupt_fallback,
    "all_corrupt_declares_reset": _store_all_corrupt,
    "capacity_sheds_new_sessions": _store_capacity,
    "ttl_eviction_snapshots_dirty_state": _store_ttl,
    "gap_resets_and_duplicates_dedupe": _store_gap,
    "abandon_keeps_snapshots": _store_abandon,
    "pinned_bytes_and_snapshot_age": _store_pinned,
}


@pytest.mark.parametrize("name", sorted(STORE_SCENARIOS))
def test_store_scenario_equals_jax(name, tmp_path, capsys):
    logs = {}
    for side_name, side in SIDES.items():
        d = tmp_path / side_name
        d.mkdir()
        logs[side_name] = []
        STORE_SCENARIOS[name](side, d, logs[side_name])
    assert logs["port"] == logs["jax"]
    log = logs["port"]
    if name == "round_trip":
        assert log[-1] == (2, ["age", "boxes", "scores", "velocity"], True)
    if name == "corrupt_quarantined_with_fallback":
        counters, files = log[-1]
        assert log[-2] == ("apply", True, True, True)  # declared, restored
        assert counters["snapshot_corrupt"] == 1
        assert any(f.endswith(".json.corrupt") for f in files)
    if name == "pinned_bytes_and_snapshot_age":
        # 4 slots x (4 + 4 + 1 + 1) float32
        assert log[0] == (0, None) and log[-1] == (160, True)


# ------------------------------------------------------ snapshot bytes


def _snapshot_dirs(tmp_path, row, seq=5, sid="cam-0"):
    """Each package's snapshot of ``row`` at ``seq``: (dir, file)."""
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / f"snap-{name}"
        store = side.mod.SessionStore(snapshot_dir=d, snapshot_every=1)
        store.admit(sid)
        store.begin_frame(sid, 0, 4)
        store._sessions[sid].seq = seq - 1
        store.commit(sid, seq, side.to_row(row))
        (f,) = d.glob("*.snap.json")
        out[name] = (d, f)
    return out


def test_snapshot_bytes_equal_jax_and_restore_across(tmp_path):
    row = _state_row(np.random.default_rng(20))
    snaps = _snapshot_dirs(tmp_path, row)
    (jd, jf), (pd, pf) = snaps["jax"], snaps["port"]
    assert jf.name == pf.name == "cam-0-000000000005.snap.json"
    assert pf.read_bytes() == jf.read_bytes()
    # each package restores the other's snapshot, bit for bit
    for reader, d in (("port", jd), ("jax", pd)):
        store = SIDES[reader].mod.SessionStore(snapshot_dir=d)
        store.admit("cam-0")
        f = store.begin_frame("cam-0", 6, 4)
        assert (f.action, f.reset, f.restored) == ("apply", False, True)
        got = f.entry.state
        assert sorted(got) == sorted(row)
        for k in row:
            assert np.asarray(got[k]).tobytes() == row[k].tobytes(), k
    # an unsafe session id hashes to the same stem in both
    assert sessions._safe_sid("a/b c") == jax_sessions._safe_sid("a/b c")


# --------------------------------------------------------- slate math


def _slates(rng, b, valid_prev=True):
    s = _state_row(rng)
    out = {k: np.stack([_state_row(rng)[k] for _ in range(b)])
           for k in s}
    out["boxes"] = rng.uniform(0, 1, size=(b, SLOTS, 4)).astype(np.float32)
    if not valid_prev:
        out["scores"][:] = 0.0  # an empty previous slate
    return out


def _dets(rng, b, n=8):
    boxes = rng.uniform(0, 1, size=(b, n, 4)).astype(np.float32)
    return {"boxes": boxes,
            "scores": rng.uniform(0.05, 1, size=(b, n)).astype(np.float32),
            "valid": rng.uniform(size=(b, n)) > 0.3}


def _case_random(rng):
    return _slates(rng, 3), _dets(rng, 3)


def _case_duplicate_scores(rng):
    slates, det = _slates(rng, 2, valid_prev=False), _dets(rng, 2)
    det["scores"][:, :] = np.float32(0.5)  # every candidate ties
    det["scores"][1, 5] = np.float32(0.75)
    det["valid"][:] = True
    det["valid"][1, 2] = False
    return slates, det


def _case_equal_distances(rng):
    slates, det = _slates(rng, 1), _dets(rng, 1)
    # previous slots 0 and 2 centred at (0.375, 0.375) and (0.625, 0.625),
    # the best detection at (0.5, 0.5): exactly equal distances
    slates["boxes"][0, 0] = [0.25, 0.25, 0.5, 0.5]
    slates["boxes"][0, 2] = [0.5, 0.5, 0.75, 0.75]
    slates["scores"][0] = [0.5, 0.0, 0.5, 0.0]
    slates["age"][0] = [3.0, 1.0, 7.0, 2.0]
    det["boxes"][0, 0] = [0.375, 0.375, 0.625, 0.625]
    det["scores"][0, 0] = 0.99
    det["valid"][0, 0] = True
    return slates, det


def _case_all_invalid(rng):
    slates, det = _slates(rng, 2), _dets(rng, 2)
    det["valid"][0] = False  # no detection at all in row 0
    return slates, det


def _case_empty_previous(rng):
    return _slates(rng, 2, valid_prev=False), _dets(rng, 2)


SLATE_CASES = {
    "random": _case_random,
    "duplicate_scores": _case_duplicate_scores,
    "equal_distances": _case_equal_distances,
    "all_invalid_row": _case_all_invalid,
    "empty_previous_slate": _case_empty_previous,
}


def _jax_call(fn, *trees, **kw):
    import jax
    import jax.numpy as jnp

    with jax.disable_jit():
        new, out = fn(*[{k: jnp.asarray(v) for k, v in t.items()}
                        for t in trees], **kw)
    return ({k: np.asarray(v) for k, v in new.items()},
            {k: np.asarray(v) for k, v in out.items()})


def _port_call(fn, *trees, **kw):
    new, out = fn(*[{k: torch.from_numpy(np.asarray(v)) for k, v in
                     t.items()} for t in trees], **kw)
    return ({k: v.numpy() for k, v in new.items()},
            {k: v.numpy() for k, v in out.items()})


def _same_slates(got, want):
    for part_got, part_want in zip(got, want):
        assert sorted(part_got) == sorted(part_want)
        for k, w in part_want.items():
            g = part_got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k in ("boxes", "velocity"):
                np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                           err_msg=k)
            else:  # scores, age and the tracked bits: exact
                np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(SLATE_CASES))
def test_slate_math_equals_jax(case):
    rng = np.random.default_rng(sorted(SLATE_CASES).index(case) + 30)
    slates, det = SLATE_CASES[case](rng)
    det = {**det, "classes": np.zeros(det["scores"].shape, np.int32)}
    kw = {"slots": SLOTS, "ema": 0.5}
    want = _jax_call(jax_sessions._track_update, slates, det, **kw)
    got = _port_call(sessions._track_update, slates, det, **kw)
    _same_slates(got, want)
    if case == "equal_distances":
        # the first of the equal distances (slot 0, age 3) is the match
        assert got[0]["age"][0, 0] == 4.0
    if case == "all_invalid_row":
        assert not got[1]["tracked"][0].any()
    adv = {"damp": 0.9, "decay": 0.9}
    _same_slates(_port_call(sessions._track_advance, got[0], **adv),
                 _jax_call(jax_sessions._track_advance, want[0], **adv))


def test_synthetic_detector_equals_jax():
    det = sessions.synthetic_detector(device="cpu")
    jdet = jax_sessions.synthetic_detector()
    x = np.random.default_rng(40).normal(
        scale=0.6, size=(5, 16, 16, 1)).astype(np.float32)
    x[0] = 0.0
    x[1] = -3.0  # tanh saturates: scores at 0.2, not valid
    got, want = det.run(x), jdet.run(x)
    assert sorted(got) == sorted(want) == [
        "boxes", "classes", "scores", "valid"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    assert not got["valid"][1].any() and got["valid"][0].all()
    assert det.task == "detect" and det.input_shape == (16, 16, 1)


# ------------------------------------------------------------- engines


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.3, size=(16, 16, 1)).astype(np.float32)
            for _ in range(n)]


def _tracking_engine(side, snap_dir, injector=None, **store_kw):
    if side == "jax":
        from deepvision_tpu.core.mesh import create_mesh
        from deepvision_tpu.serve import InferenceEngine as JaxEngine

        det = jax_sessions.synthetic_detector()
        store = jax_sessions.SessionStore(snapshot_dir=snap_dir,
                                          injector=injector, **store_kw)
        track = jax_sessions.TrackingPipeline("track", det, store,
                                              detect_every=4)
        return JaxEngine([det, track], mesh=create_mesh(1, 1),
                         buckets=(4,), batch_window_s=0.002), store
    from deepvision_tpu_torch.serve import InferenceEngine

    det = sessions.synthetic_detector(device="cpu")
    store = sessions.SessionStore(snapshot_dir=snap_dir, injector=injector,
                                  **store_kw)
    track = sessions.TrackingPipeline("track", det, store, detect_every=4)
    return InferenceEngine([det, track], buckets=(4,),
                           batch_window_s=0.002), store


def _answers_match(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not isinstance(w, dict):
            assert g == w
            continue
        assert sorted(g) == sorted(w), (g, w)
        for k in w:
            if k in ("boxes", "scores"):
                np.testing.assert_allclose(np.asarray(g[k]),
                                           np.asarray(w[k]), rtol=0,
                                           atol=TOL, err_msg=k)
            else:
                assert g[k] == w[k], (k, g, w)


def _eng_in_order(side, d):
    xs = _frames(9, 10)
    eng, _ = _tracking_engine(side, d, snapshot_every=3)
    try:
        futs = [eng.submit(xs[i], model="track", session="s1", seq=i)
                for i in range(8)]
        out = [f.result(timeout=60) for f in futs]
        out.append(eng.submit(xs[8], model="track", session="s1",
                              seq=3).result(timeout=60))
        h = eng.health()["sessions"]
        out.append({"live": h["live"], "pinned": h["pinned_bytes"],
                    "opened": eng.stats()["sessions"]["track"][
                        "counters"]["opened"]})
    finally:
        eng.close()
    return out


def _eng_dedupe(side, d):
    xs = _frames(6, 11)
    eng, store = _tracking_engine(side, d)
    done, lock = [], threading.Lock()
    try:
        futs = []
        for i in range(6):
            fut = eng.submit(xs[i], model="track", session="s1", seq=i)
            fut.add_done_callback(
                lambda f, i=i: (lock.acquire(), done.append(i),
                                lock.release()))
            futs.append(fut)
        out = [f.result(timeout=60) for f in futs]
        wait_until(lambda: len(done) == 6, msg="every callback")
        c = store.stats()["counters"]
        out.append({"done": list(done), "duplicates": c["duplicates"],
                    "resets": c["resets"]})
    finally:
        eng.close()
    return out


def _eng_malformed(side, d):
    (x,) = _frames(1, 12)
    eng, _ = _tracking_engine(side, d)
    out = []
    try:
        if side == "port":  # a session id names files: a string
            with pytest.raises(ValueError, match="must be a string"):
                eng.submit(x, model="track", session=7, seq=0)
        for kw, match in (({"model": "track"}, "requires session"),
                          ({"model": "synth", "session": "s", "seq": 0},
                           "stateless"),
                          ({"model": "track", "session": "s", "seq": -1},
                           "seq must be")):
            with pytest.raises(ValueError, match=match):
                eng.submit(x, **kw)
            out.append(match)
    finally:
        eng.close()
    return out


def _eng_close_restores(side, d):
    xs = _frames(5, 13)
    eng, _ = _tracking_engine(side, d, snapshot_every=100)
    try:
        out = [eng.submit(x, model="track", session="s1",
                          seq=i).result(timeout=60)
               for i, x in enumerate(xs[:4])]
    finally:
        eng.close()  # graceful: flushes the dirty slate
    eng2, store2 = _tracking_engine(side, d, snapshot_every=100)
    try:
        out.append(eng2.submit(xs[4], model="track", session="s1",
                               seq=4).result(timeout=60))
        out.append({"restores": store2.stats()["counters"]["restores"]})
    finally:
        eng2.close()
    return out


ENGINE_SCENARIOS = {
    "stream_in_order": _eng_in_order,
    "batch_dedupes_same_session": _eng_dedupe,
    "rejects_malformed_submits": _eng_malformed,
    "close_flushes_then_restores": _eng_close_restores,
}


@pytest.mark.parametrize("name", sorted(ENGINE_SCENARIOS))
def test_engine_scenario_equals_jax(name, tmp_path):
    got = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        got[side] = ENGINE_SCENARIOS[name](side, d)
    _answers_match(got["port"], got["jax"])
    out = got["port"]
    if name == "stream_in_order":
        for i, r in enumerate(out[:8]):
            assert (r["session"], r["seq"], r["state_reset"]) == (
                "s1", i, False)
            assert r["detected"] == (i % 4 == 0)
            assert len(r["boxes"]) == SLOTS and any(r["tracked"])
        assert out[8] == {"session": "s1", "seq": 3, "replayed": True,
                          "state_reset": False}
        assert out[9] == {"live": 1, "pinned": 160, "opened": 1}
    if name == "batch_dedupes_same_session":
        assert out[-1] == {"done": list(range(6)), "duplicates": 0,
                           "resets": 0}
    if name == "close_flushes_then_restores":
        assert out[4]["state_reset"] is False and out[-1] == {"restores": 1}


def test_committed_state_is_a_clone_of_the_static_output(tmp_path):
    """The clone trap: a program's static outputs are overwritten by its
    next call, so a committed row must be a copy. Stream A's detect frame
    shares a batch with B's (rows 0 and 1); B then runs alone until its
    next detect frame lands in row 0 of the detect program; A's next
    frames must still read A's own state."""
    xs = {s: _frames(6, 14 + k) for k, s in enumerate("AB")}
    eng, store = _tracking_engine("port", tmp_path / "p")
    try:
        eng.pause()
        first = [eng.submit(xs[s][0], model="track", session=s, seq=0)
                 for s in "AB"]
        eng.resume()
        got = {"A": [first[0].result(timeout=60)],
               "B": [first[1].result(timeout=60)]}
        for i in range(1, 5):  # B's 4th frame is a detect frame, alone
            got["B"].append(eng.submit(xs["B"][i], model="track",
                                       session="B", seq=i).result(
                                           timeout=60))
        for i in range(1, 3):
            got["A"].append(eng.submit(xs["A"][i], model="track",
                                       session="A", seq=i).result(
                                           timeout=60))
        runner = next(r for k, r in eng._cache.items() if k[0] == "track")
        state = store._sessions["A"].state
        outs = {*(t.untyped_storage().data_ptr() for t in
                  runner.detect.slates_out.values()),
                *(t.untyped_storage().data_ptr() for t in
                  runner.advance.slates_out.values())}
        assert not {t.untyped_storage().data_ptr()
                    for t in state.values()} & outs
    finally:
        eng.close()
    for s, answers in got.items():  # each stream alone, in a fresh engine
        alone, _ = _tracking_engine("port", tmp_path / f"alone-{s}")
        try:
            want = [alone.submit(x, model="track", session=s,
                                 seq=i).result(timeout=60)
                    for i, x in enumerate(xs[s][:len(answers)])]
        finally:
            alone.close()
        assert answers == want, s


def _fault_session_kill(side, d):
    """``session_kill`` drops seq 4's state after its answer (snapshots
    at seq 1 and 3): frame 5 declares the reset; the client's re-sent
    frames from 4 restore the seq-3 snapshot and go on without one,
    frame 4's answer the same as the first time."""
    if side == "jax":
        from deepvision_tpu.resilience import FaultInjector as Injector
    else:
        Injector = FaultInjector
    xs = _frames(8, 15)
    eng, store = _tracking_engine(side, d, snapshot_every=2,
                                  injector=Injector("session_kill@4"))
    try:
        out = [eng.submit(x, model="track", session="s",
                          seq=i).result(timeout=60)
               for i, x in enumerate(xs[:5])]
        killed = dict(store.stats()["counters"])
        # re-sent from the snapshot on: restored, no reset
        out += [eng.submit(xs[i], model="track", session="s",
                           seq=i).result(timeout=60) for i in (4, 5, 6)]
        c = store.stats()["counters"]
        out.append({"killed": killed["killed"], "restores": c["restores"],
                    "resets": c["resets"]})
        # and a frame past a gap declares its reset
        out.append(eng.submit(xs[7], model="track", session="s",
                              seq=9).result(timeout=60))
    finally:
        eng.close()
    return out


def _fault_snapshot_corrupt(side, d):
    """``snapshot_corrupt`` garbles the seq-3 snapshot: a fresh engine
    over the directory quarantines it and restores seq 1, from which the
    client's frames go on without a reset."""
    if side == "jax":
        from deepvision_tpu.resilience import FaultInjector as Injector
    else:
        Injector = FaultInjector
    xs = _frames(6, 16)
    eng, _ = _tracking_engine(side, d, snapshot_every=2,
                              injector=Injector("snapshot_corrupt@1"))
    try:
        out = [eng.submit(x, model="track", session="s",
                          seq=i).result(timeout=60)
               for i, x in enumerate(xs[:4])]
    finally:
        eng.close(abandon_sessions=True)  # crash semantics: no flush
    eng2, store2 = _tracking_engine(side, d, snapshot_every=2)
    try:
        out += [eng2.submit(xs[i], model="track", session="s",
                            seq=i).result(timeout=60) for i in (2, 3, 4, 5)]
        c = store2.stats()["counters"]
        out.append({"corrupt": c["snapshot_corrupt"],
                    "restores": c["restores"], "resets": c["resets"],
                    "quarantined": len(list(d.glob("*.json.corrupt")))})
    finally:
        eng2.close()
    return out


@pytest.mark.parametrize("name", ["session_kill", "snapshot_corrupt"])
def test_fault_site_equals_jax(name, tmp_path, capsys):
    scenario = {"session_kill": _fault_session_kill,
                "snapshot_corrupt": _fault_snapshot_corrupt}[name]
    got = {side: scenario(side, tmp_path / side) for side in ("jax", "port")}
    _answers_match(got["port"], got["jax"])
    out = got["port"]
    if name == "session_kill":
        first, resent, counters, gap = out[:5], out[5:8], out[8], out[9]
        assert not any(r["state_reset"] for r in first + resent)
        assert counters == {"killed": 1, "restores": 1, "resets": 0}
        # the re-sent frame 4 from the restored seq-3 state: the same answer
        assert resent[0] == first[4]
        assert gap["state_reset"] is True
    else:
        assert not any(r["state_reset"] for r in out[:-1])
        assert out[-1] == {"corrupt": 1, "restores": 1, "resets": 0,
                           "quarantined": 1}
        # the seq-1 snapshot and the same frames: the same answers
        assert out[4:6] == out[2:4]


# -------------------------------------------------------------- router


def _stream_fleet(snap_dir, n=2, **kw):
    from deepvision_tpu_torch.serve import EngineReplica, FleetRouter

    def factory(sid):
        def build():
            det = sessions.synthetic_detector(device="cpu")
            store = sessions.SessionStore(snapshot_dir=snap_dir,
                                          snapshot_every=3)
            return [det, sessions.TrackingPipeline("track", det, store,
                                                   detect_every=4)]

        return EngineReplica(sid, build, buckets=(4,))

    return FleetRouter(factory, replicas=n, models=["synth", "track"],
                       max_queue=256, default_deadline_s=60.0,
                       probe_interval_s=0.05, **kw)


def _jax_stream_answers(streams: dict, d: Path) -> dict:
    """Each stream alone through a JAX tracking engine, in order."""
    eng, _ = _tracking_engine("jax", d)
    try:
        return {s: [eng.submit(x, model="track", session=s,
                               seq=i).result(timeout=60)
                    for i, x in enumerate(xs)]
                for s, xs in streams.items()}
    finally:
        eng.close()


def test_sticky_routing_survives_kill_in_order(tmp_path):
    streams = {s: _frames(12, 17 + k) for k, s in enumerate(("sA", "sB"))}
    fleet = _stream_fleet(tmp_path / "snaps")
    done = {"sA": [], "sB": []}
    lock = threading.Lock()
    outs = {}

    def submit(s, i):
        fut = fleet.submit(streams[s][i], model="track", session=s, seq=i)

        def cb(f, s=s, i=i):
            with lock:
                done[s].append(i)

        fut.add_done_callback(cb)
        return s, i, fut

    try:
        for s, i, f in [submit(s, i) for i in range(6) for s in streams]:
            outs[(s, i)] = f.result(timeout=60)
        pins = fleet.stats()["sessions"]["pins"]
        assert set(pins) == set(streams)
        with fleet._lock:
            by_sid = {sl.sid: sl for sl in fleet._slots
                      if sl.state == "ready"}
        # kill a replica that holds a pin: its streams migrate, replay and
        # go on without a reset
        by_sid[sorted(set(pins.values()))[0]].replica.kill()
        for s, i, f in [submit(s, i) for i in range(6, 12) for s in streams]:
            outs[(s, i)] = f.result(timeout=60)
        wait_until(lambda: fleet.telemetry.completed == 24,
                   msg="every frame counted")
        stats = fleet.stats()
    finally:
        fleet.close()
    for s in streams:
        assert done[s] == list(range(12))
    assert not any(r["state_reset"] for r in outs.values())
    tel = fleet.telemetry
    assert tel.sessions_migrated >= 1 and tel.session_resets == 0
    assert "sessions_migrated=" in tel.summary_line()
    assert stats["sessions"]["live"] == 2
    want = _jax_stream_answers(streams, tmp_path / "jax")
    for s in streams:
        _answers_match([outs[(s, i)] for i in range(12)], want[s])


def test_router_drains_a_stream_fifo(tmp_path):
    xs = _frames(8, 19)
    fleet = _stream_fleet(tmp_path, n=1)
    order, lock, futs = [], threading.Lock(), []
    try:
        for i, x in enumerate(xs):
            fut = fleet.submit(x, model="track", session="s", seq=i)
            fut.add_done_callback(
                lambda f, i=i: (lock.acquire(), order.append(i),
                                lock.release()))
            futs.append(fut)
        answers = [f.result(timeout=60) for f in futs]
    finally:
        fleet.close()
    assert order == list(range(8))
    assert [r["seq"] for r in answers] == list(range(8))


class _Fake:
    """A replica double that the pin computation needs: nothing."""

    def __init__(self, rid):
        self.replica_id = rid

    def start(self):
        pass

    def stop(self):
        pass

    def kill(self):
        pass

    def probe(self):
        return {"status": "ok"}

    def stats(self):
        return {"telemetry": {}}


def test_pins_equal_jax_crc32_pins():
    from deepvision_tpu.serve import router as jax_router
    from deepvision_tpu_torch.serve import router

    sids = [f"cam{i}" for i in range(12)] + ["a b", "ü", ""]
    pins = {}
    for mod in (jax_router, router):
        fleet = mod.FleetRouter(_Fake, replicas=3, models=["track"],
                                probe_interval_s=10.0)
        try:
            got = []
            for sid in sids:
                slot, migrated = fleet._pin_slot(mod._SessionRoute(sid, 4))
                got.append((slot.sid, migrated))
            pins[mod.__name__] = got
        finally:
            fleet.close()
    assert pins["deepvision_tpu_torch.serve.router"] == \
        pins["deepvision_tpu.serve.router"]
    assert {p for p, _ in pins["deepvision_tpu_torch.serve.router"]} == {
        "r1", "r2", "r3"}


def test_replayed_reset_is_passed_on(tmp_path):
    """No snapshot directory and a window of 2: after the pin dies, the
    replay restarts from seq 4 on a survivor with no lineage, which
    declares a reset; the client's frame 6 carries it, and the router
    counts it."""
    from deepvision_tpu_torch.serve import EngineReplica, FleetRouter

    def factory(sid):
        def build():
            det = sessions.synthetic_detector(device="cpu")
            return [det, sessions.TrackingPipeline(
                "track", det, sessions.SessionStore(), detect_every=4)]

        return EngineReplica(sid, build, buckets=(4,))

    xs = _frames(8, 21)
    fleet = FleetRouter(factory, replicas=2, models=["synth", "track"],
                        default_deadline_s=60.0, probe_interval_s=0.05,
                        session_replay_window=2)
    try:
        first = [fleet.submit(x, model="track", session="s",
                              seq=i).result(timeout=60)
                 for i, x in enumerate(xs[:6])]
        pin = fleet.stats()["sessions"]["pins"]["s"]
        with fleet._lock:
            (victim,) = [sl for sl in fleet._slots if sl.sid == pin]
        victim.replica.kill()
        after = [fleet.submit(xs[i], model="track", session="s",
                              seq=i).result(timeout=60) for i in (6, 7)]
        wait_until(lambda: fleet.telemetry.completed == 8,
                   msg="every frame counted")
    finally:
        fleet.close()
    assert not any(r["state_reset"] for r in first)
    assert after[0]["state_reset"] is True  # the replay's reset, passed on
    assert after[1]["state_reset"] is False
    assert fleet.telemetry.session_resets == 1
    assert fleet.telemetry.sessions_migrated == 1


def test_session_on_a_stateless_model_is_refused(tmp_path):
    (x,) = _frames(1, 22)
    fleet = _stream_fleet(tmp_path, n=1)
    try:
        with pytest.raises(ValueError, match="stateless"):
            fleet.submit(x, model="synth", session="s",
                         seq=0).result(timeout=60)
        assert "boxes" in fleet.submit(x, model="synth").result(timeout=60)
    finally:
        fleet.close()


# ------------------------------------------------------------- the CLI


def test_cli_stream_fleet_survives_a_kill(tmp_path, monkeypatch):
    """The port's ``make stream-smoke``: 4 streams x 12 frames through
    ``--fleet 2 --track synth:4`` while ``replica_kill@20`` SIGKILLs a
    replica mid-stream."""
    from deepvision_tpu_torch.serve.__main__ import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rng = np.random.default_rng(0)
    lines = [json.dumps({"id": f"cam{s}-{i}", "model": "track",
                         "session": f"cam{s}", "seq": i,
                         "input": (rng.standard_normal((16, 16, 1))
                                   * 0.3).tolist()}) + "\n"
             for i in range(12) for s in range(4)]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--fleet", "2", "--track", "synth:4", "--buckets", "4",
                   "--snapshot-every", "3", "--faults", "replica_kill@20",
                   "--timeout-s", "20", "--device", "cpu"],
                  stdin=iter(lines), stdout=out)
    assert rc == 0
    assert not torch.cuda.is_initialized()
    rows = [json.loads(s) for s in out.getvalue().splitlines()]
    ok = [r for r in rows if "result" in r]
    assert len(ok) == 48, rows[:3]
    assert not [r for r in ok if r["result"].get("state_reset")]
    seqs: dict = {}
    for r in ok:
        seqs.setdefault(r["result"]["session"], []).append(
            r["result"]["seq"])
    assert all(v == list(range(12)) for v in seqs.values()), seqs
    text = err.getvalue()
    assert re.search(r"sessions_migrated=[1-9]", text), text[-2000:]
    assert re.search(r" resets=0", text) and re.search(r"deaths=1", text)
    assert "re-pinned to" in text
