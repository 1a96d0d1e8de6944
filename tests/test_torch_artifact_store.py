"""The port's artifact store against the JAX package's, on the CPU.

Each store test runs one sequence of ``put``/``get``/``reject`` with the
same bytes and the same key fields on the JAX ``ArtifactStore`` and on
the port's (``deepvision_tpu_torch/serve/artifact_store.py``), and
compares what both leave: the manifest entries' sizes and SHA-256, the
files moved to ``quarantine/`` and ``stats()``. Each engine test runs the
twin of a ``tests/test_tenancy.py`` store test on the JAX engine (its toy
linear model) and on the port's (the same toy as a module), and compares
the engines' store counters, the runners warmed from the store and the
answers, which are the same float32 arithmetic on both.
"""

import hashlib

import numpy as np
import torch
from torch import nn

from deepvision_tpu.serve.artifact_store import ArtifactStore as JaxStore
from deepvision_tpu_torch.serve import InferenceEngine, ServedModel
from deepvision_tpu_torch.serve.artifact_store import (
    ArtifactStore,
    device_desc,
)
from tests.test_tenancy import expected_toy, make_engine, toy_model
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


def _quiet(*args, **kwargs):
    pass


# ------------------------------------------------------- store alone


def _run_both(tmp_path, sequence):
    """``sequence(make_store, key, root)`` on the JAX store and on the
    port's, each over its own directory with the same key fields (the
    descriptor ``cpu:1`` under JAX's ``mesh`` and the port's ``device``);
    returns the two results."""
    out = []
    for store, desc in ((JaxStore, "mesh"), (ArtifactStore, "device")):
        root = tmp_path / desc

        def make(store=store, root=root):
            return store(root, log=_quiet)

        def key(desc=desc, **kw):
            return {"model": "m", "bucket": 1, "dtype": "float32",
                    "fingerprint": "f", **kw, desc: "cpu:1"}

        out.append(sequence(make, key, root))
    return out


def _left(store, root) -> dict:
    """What a store leaves: each entry's size and SHA-256 by key, the
    quarantined files (without the blob suffix) and its counters."""
    quarantine = root / "quarantine"
    return {
        "entries": {k: (e["size"], e["sha256"])
                    for k, e in store.entries().items()},
        "quarantine": sorted(
            p.name.replace(".stablehlo", "").replace(".pt2", "")
            for p in quarantine.iterdir()) if quarantine.is_dir() else [],
        "stats": {k: v for k, v in store.stats().items() if k != "root"}}


def test_put_is_idempotent_and_manifest_survives_garbage(tmp_path):
    """Twin of ``test_store_put_is_idempotent_and_manifest_survives_
    garbage``."""
    def sequence(make, key, root):
        store = make()
        store.put(b"payload", **key(fingerprint="abc"))
        store.put(b"payload", **key(fingerprint="abc"))
        got = store.get(**key(fingerprint="abc"))
        before = _left(store, root)
        (root / "manifest.json").write_text("{ not json")
        store2 = make()
        return (got, before, store2.get(**key(fingerprint="abc")),
                _left(store2, root))

    jax_side, port_side = _run_both(tmp_path, sequence)
    assert port_side == jax_side
    got, before, again, after = port_side
    assert got == b"payload" and again is None
    assert before["entries"] == {"m|1|float32|cpu:1|abc": (
        7, hashlib.sha256(b"payload").hexdigest())}
    assert before["stats"]["puts"] == 2 and after["stats"]["entries"] == 0


def test_get_sees_other_writers_puts(tmp_path):
    """Twin of ``test_store_get_sees_other_writers_puts``."""
    def sequence(make, key, root):
        reader, writer = make(), make()
        miss = reader.get(**key(bucket=4))
        writer.put(b"fresh", **key(bucket=4))
        return miss, reader.get(**key(bucket=4)), _left(reader, root)

    jax_side, port_side = _run_both(tmp_path, sequence)
    assert port_side == jax_side
    assert port_side[:2] == (None, b"fresh")


def test_commit_merges_sibling_entries(tmp_path):
    """Twin of ``test_manifest_commit_merges_sibling_replica_entries``:
    one writer's commit does not orphan another's blobs."""
    def sequence(make, key, root):
        a, b = make(), make()
        a.put(b"aaa", **key(model="ma"))
        b.put(b"bbb", **key(model="mb"))
        a.put(b"ccc", **key(model="mc"))
        fresh = make()
        return ([fresh.get(**key(model=m)) for m in ("ma", "mb", "mc")],
                _left(fresh, root))

    jax_side, port_side = _run_both(tmp_path, sequence)
    assert port_side == jax_side
    assert port_side[0] == [b"aaa", b"bbb", b"ccc"]


def test_quarantined_key_not_resurrected_by_sibling_merge(tmp_path):
    """Twin of ``test_quarantined_key_not_resurrected_by_sibling_merge``:
    a corrupt blob is moved to quarantine on read, and a later commit's
    merge of a sibling's manifest does not bring its key back."""
    def sequence(make, key, root):
        a, b = make(), make()
        b.put(b"payload", **key())
        blob = next(p for p in (root / "blobs").rglob("*") if p.is_file())
        blob.write_bytes(b"corrupt!")
        first = a.get(**key())
        a.put(b"other", **key(model="m2"))
        fresh = make()
        return (first, fresh.get(**key()), fresh.get(**key(model="m2")),
                _left(a, root), _left(fresh, root))

    jax_side, port_side = _run_both(tmp_path, sequence)
    assert port_side == jax_side
    first, dead, other, left_a, _ = port_side
    assert first is None and dead is None and other == b"other"
    assert left_a["stats"]["quarantined"] == 1
    assert len(left_a["quarantine"]) == 1


def test_reject_quarantines_a_verified_entry(tmp_path):
    """``reject`` (the warm-up's path for a program that loads but cannot
    run) quarantines an entry whose bytes verified, on both stores."""
    def sequence(make, key, root):
        store = make()
        store.put(b"runs nowhere", **key())
        store.reject(**key(), reason="failed to run")
        store.reject(**key(model="unknown"), reason="no such entry")
        return store.get(**key()), _left(store, root)

    jax_side, port_side = _run_both(tmp_path, sequence)
    assert port_side == jax_side
    assert port_side[0] is None
    assert port_side[1]["stats"]["quarantined"] == 1


# ------------------------------------------------------ engine twins


class _Toy(nn.Module):
    """``tests/test_tenancy.toy_model``'s forward as a module:
    ``y = x * w + 0.5``."""

    def __init__(self, weight: float):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([weight]), requires_grad=False)

    def forward(self, x):
        return {"y": x * self.w + 0.5}


def _port_toy(name="a", weight=2.0, dim=3) -> ServedModel:
    module = _Toy(weight).eval()
    return ServedModel(
        name=name, task="classify", module=module, input_shape=(dim,),
        postprocess=lambda host, i: {"y": np.asarray(host["y"][i]).tolist()},
        device=torch.device("cpu"), forward=module)


def _port_engine(models, **kw):
    kw.setdefault("buckets", (1, 4))
    return InferenceEngine(models, **kw)


def _engine_state(eng) -> dict:
    stats = eng.stats()
    store = {k: v for k, v in stats["artifact_store"].items() if k != "root"}
    return {"store": store, "warmed": stats["warmed_from_store"],
            "misses": stats["cache"]["misses"]}


def _blob(store_dir, bucket: int):
    """The blob file of ``bucket``'s entry (either store's manifest)."""
    (entry,) = [e for e in JaxStore(store_dir, log=_quiet).entries().values()
                if e["bucket"] == bucket]
    return store_dir / entry["file"]


def _answer(eng, x, weight=2.0):
    r = eng.submit(x, model="a").result(timeout=60)
    np.testing.assert_array_equal(np.asarray(r["y"], np.float32),
                                  expected_toy(x, weight))
    return r


def _twin(tmp_path, run):
    """``run(make_engine, make_model, store_dir)`` on the JAX engine and
    on the port's; both results."""
    return [run(make_engine, lambda name="a", weight=2.0:
                toy_model(name, weight), tmp_path / "jax"),
            run(_port_engine, _port_toy, tmp_path / "port")]


def test_store_roundtrip_and_cold_engine_warms_from_disk(tmp_path):
    """Twin of ``test_store_roundtrip_and_cold_engine_warms_from_disk``:
    the cold engine exports its ladder, a fresh engine over the same
    directory warms both buckets from it with no cache miss and answers
    the same."""
    x = np.ones(3, np.float32)

    def run(engine, model, store):
        with engine([model()], store=str(store)) as eng:
            cold = (_engine_state(eng), _answer(eng, x))
        with engine([model()], store=str(store)) as eng:
            warm = (_engine_state(eng), _answer(eng, x))
        return cold, warm

    jax_side, port_side = _twin(tmp_path, run)
    assert port_side == jax_side
    (cold, r1), (warm, r2) = port_side
    assert cold["store"]["puts"] == 2 and cold["warmed"] == []
    assert warm["warmed"] == ["a@1", "a@4"] and warm["misses"] == 0
    assert r1 == r2


def test_corrupt_entry_quarantined_with_trace_fallback(tmp_path):
    """Twin of ``test_corrupt_store_entry_quarantined_with_trace_
    fallback`` (the bucket-1 blob corrupted on both sides): quarantined,
    that bucket traced, the other warmed from disk, the same answers."""
    x = np.ones(3, np.float32)

    def run(engine, model, store):
        with engine([model()], store=str(store)) as eng:
            r1 = _answer(eng, x)
        blob = _blob(store, 1)
        blob.write_bytes(b"not a program")
        with engine([model()], store=str(store)) as eng:
            state = _engine_state(eng)
            r2 = _answer(eng, x)
        assert (store / "quarantine" / blob.name).is_file()
        return state, r1, r2

    jax_side, port_side = _twin(tmp_path, run)
    assert port_side == jax_side
    state, r1, r2 = port_side
    assert state["store"]["quarantined"] == 1 and r1 == r2
    assert state["warmed"] == ["a@4"] and state["misses"] == 1


def test_store_keys_include_the_fingerprint(tmp_path):
    """The fingerprint half of ``test_store_keys_include_fingerprint_and_
    swap_exports_new``: other weights give another key, so the engine
    traces and exports anew beside the old entries, and the next engine
    on those weights warms from the new ones."""
    x = np.ones(3, np.float32)

    def run(engine, model, store):
        states = []
        for weight in (2.0, 6.0, 6.0):
            with engine([model("a", weight)], store=str(store)) as eng:
                _answer(eng, x, weight)
                states.append(_engine_state(eng))
        entries = JaxStore(store, log=_quiet).entries().values()
        return states, len({e["fingerprint"] for e in entries})

    jax_side, port_side = _twin(tmp_path, run)
    assert port_side == jax_side
    (first, other, again), fingerprints = port_side
    assert other["warmed"] == [] and other["store"]["puts"] == 2
    assert other["store"]["entries"] == 4 and fingerprints == 2
    assert again["warmed"] == ["a@1", "a@4"] and again["misses"] == 0


def test_unrunnable_entry_rejected_with_trace_fallback(tmp_path):
    """Twin of ``test_unrunnable_store_entry_rejected_with_trace_
    fallback``: a valid program of bucket 4 filed under the bucket-1 key
    loads, fails on a bucket-1 batch, is rejected into quarantine, and
    the engine traces and answers."""
    from deepvision_tpu.core.mesh import create_mesh
    from deepvision_tpu.serve.artifact_store import mesh_desc

    x = np.ones(3, np.float32)

    def run(engine, model, store, desc):
        m = model()
        key = {"model": "a", "bucket": 1, "dtype": m.dtype_str,
               "fingerprint": m.weights_fingerprint(), **desc}
        (JaxStore if "mesh" in desc else ArtifactStore)(
            store, log=_quiet).put(m.export_bytes(4), **key)
        with engine([model()], buckets=(1,), store=str(store)) as eng:
            state = _engine_state(eng)
            r = _answer(eng, x)
        return state, r

    jax_side = run(lambda models, **kw: make_engine(
        models, mesh=create_mesh(1, 1), **kw), lambda: toy_model("a"),
        tmp_path / "jax", {"mesh": mesh_desc(create_mesh(1, 1))})
    port_side = run(_port_engine, _port_toy, tmp_path / "port",
                    {"device": device_desc("cpu")})
    assert port_side == jax_side
    state, _ = port_side
    assert state["store"]["quarantined"] == 1 and state["warmed"] == []
    assert state["store"]["puts"] == 0  # no re-export of a rejected key


def test_device_desc_names_platform_and_count():
    assert device_desc("cpu") == "cpu:1"
    assert device_desc(torch.device("cpu")) == "cpu:1"


def test_serving_cli_store_warms_the_next_start(tmp_path, capsys):
    """``serve --store DIR`` exports the traced runner at the first start
    and loads it at the second, whose warm line counts it (as
    ``serve.py``'s does), with the same answers."""
    import io
    import json

    from deepvision_tpu_torch.serve.__main__ import main as serve_main

    x = np.random.default_rng(0).normal(size=(32, 32, 1))
    line = json.dumps({"id": 1, "input": x.tolist()}) + "\n"
    answers, warm_lines = [], []
    for _ in range(2):
        out = io.StringIO()
        serve_main(["-m", "lenet5", "--num-classes", "10", "--device", "cpu",
                    "--buckets", "1", "--store", str(tmp_path / "aot")],
                   stdin=io.StringIO(line), stdout=out)
        answers.append(json.loads(out.getvalue())["result"])
        warm_lines += [s for s in capsys.readouterr().err.splitlines()
                       if s.startswith("warmup done")]
    assert answers[0] == answers[1]
    assert "(1 runners)" in warm_lines[0]
    assert "(1 runners, 1 from store)" in warm_lines[1]
    assert len(list((tmp_path / "aot" / "blobs" / "lenet5").iterdir())) == 1
