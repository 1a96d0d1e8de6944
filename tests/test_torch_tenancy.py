"""The port's multi-tenant serving against the JAX package's, on the CPU.

``deepvision_tpu_torch/serve/tenancy.py`` and its seams (the engine's
residency and ``hot_swap``, per-tenant admission, the router's tenant
maps, ``POST /v1/swap``, the serving CLI's flags and swap control):

- the twins of ``tests/test_tenancy.py``'s engine scenarios, each run
  through the JAX engine (its toy linear model) and the port's (the same
  toy as a module): LRU under a budget with bit-equal re-materialization,
  an explicit evict (and one that waits out a batch in flight), a lone
  tenant, swaps under load, concurrent, same-fingerprint and retried
  swaps, retired editions pinned by a runner, bad arguments, cache keys
  across a swap, a frozen cache, quota and SLO-class sheds by tenant and
  admission's argument errors. Both sides must give the same
  ``summary_line`` counters and ``stats()["tenancy"]`` lists, and
  answers equal within ``TOY_TOL`` (the same float32 ``x * w + 0.5``);
- the store twins: a swap exports the new fingerprint, and a
  store-warmed tenant gives back its edition's copy; a swap from a
  checkpoint directory (``workdir=``) serves that checkpoint;
- a narrow real model that reaches the LRN op: ``alexnet1`` at 64 px
  with the JAX weights carried across by ``convert.from_flax``, the same
  weight bytes on both sides (``tree_nbytes``), answers within
  ``REAL_TOL`` after an eviction and restore and after
  ``hot_swap(perturb=0.01)``, whose new weights equal JAX's bit for
  bit (the nudge saturates the fresh model's softmax, so classes are
  compared where their probabilities are not tied);
- a DAG (``tests/test_pipeline.py``'s toy ``detpose``) and a
  ``TrackingPipeline`` over an evicted stage tenant: its runners
  re-installed (recaptured, never a miss on the frozen cache) and its
  answers as before; after a swap the DAG answers on its old weights and
  the front door on the new ones, as the JAX engine does;
- the CLI (stdin swap control, the ``[tenancy]`` line, bad
  ``NAME=VALUE`` maps against ``serve.py``'s), a fleet's child argv and
  router maps, ``POST /v1/swap`` on one engine and on a fleet, and the
  router's sheds by tenant on both sides.
"""

import contextlib
import gc
import http.client
import io
import json
import shutil
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import serve as jax_serve_cli  # noqa: E402
from deepvision_tpu.core.mesh import create_mesh  # noqa: E402
from deepvision_tpu.serve import (  # noqa: E402
    AdmissionController as JaxAdmission,
    InferenceEngine as JaxEngine,
    ShedError as JaxShedError,
)
from deepvision_tpu.serve import pipeline as jax_pipeline  # noqa: E402
from deepvision_tpu.serve.models import (  # noqa: E402
    load_served as jax_load_served,
)
from deepvision_tpu.serve.tenancy import (  # noqa: E402
    tree_nbytes as jax_tree_nbytes,
)
from deepvision_tpu_torch.obs.metrics import Registry  # noqa: E402
from deepvision_tpu_torch.resilience.sentinel import state_tree  # noqa: E402
from deepvision_tpu_torch.serve import (  # noqa: E402
    AdmissionController,
    InferenceEngine,
    Pipeline,
    PipelineSpec,
    ServedModel,
    ShedError,
    load_served,
    tree_nbytes,
)
from deepvision_tpu_torch.serve import __main__ as port_cli  # noqa: E402
from deepvision_tpu_torch.serve import models as port_models  # noqa: E402
from deepvision_tpu_torch.serve.http import (  # noqa: E402
    make_handler,
    make_server,
)
from deepvision_tpu_torch.serve.sessions import (  # noqa: E402
    SessionStore,
    TrackingPipeline,
)
from deepvision_tpu_torch.serve.telemetry import ServeTelemetry  # noqa: E402
from tests.test_pipeline import detpose_json  # noqa: E402
from tests.test_pipeline import toy_detector as jax_toy_detector  # noqa: E402
from tests.test_pipeline import toy_pose as jax_toy_pose  # noqa: E402
from tests.test_tenancy import make_engine as jax_make_engine  # noqa: E402
from tests.test_tenancy import toy_model as jax_toy_model  # noqa: E402
from tests.test_torch_router import SIDES, FakeReplica  # noqa: E402
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)

TOY_TOL = 1e-6  # the toy's float32 x * w + 0.5, port against JAX, abs
REAL_TOL = 1e-5  # alexnet1's probabilities, port against JAX, abs
DAG_TOL = 1e-5  # the toy DAG's boxes and joints, port against JAX, abs
SIDE_NAMES = ("jax", "port")


# ------------------------------------------------------------- toys


class _Toy(torch.nn.Module):
    """``tests/test_tenancy.toy_model``'s forward as a module:
    ``y = x * w + 0.5``; its 4 weight bytes are the JAX toy's."""

    def __init__(self, weight: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([weight]),
                                    requires_grad=False)

    def forward(self, x):
        return {"y": x * self.w + 0.5}


def _toy_post(host, i):
    return {"y": np.asarray(host["y"][i]).tolist()}


def port_toy(name="a", weight=2.0) -> ServedModel:
    module = _Toy(weight).eval()
    return ServedModel(
        name=name, task="classify", module=module, input_shape=(3,),
        postprocess=_toy_post, device=torch.device("cpu"), forward=module,
        make_forward=lambda m: m)


def toy(side, name="a", weight=2.0):
    return (jax_toy_model(name, weight) if side == "jax"
            else port_toy(name, weight))


def weights(side, w: float):
    """The toy's weights ``w`` as each side's ``hot_swap`` takes them:
    JAX's variables, and the port's tree in the JAX layout
    (``state_tree``)."""
    if side == "jax":
        return {"w": np.float32(w)}
    return {"params": {"w": np.array([w], np.float32)}}


def engine(side, models, **kw):
    kw.setdefault("buckets", (1, 4))
    if side == "jax":
        return jax_make_engine(models, **kw)
    return InferenceEngine(models, telemetry=ServeTelemetry(Registry()), **kw)


def expected(x, w):
    return np.asarray(x, np.float32) * np.float32(w) + np.float32(0.5)


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=3).astype(np.float32)


def counters(eng) -> list[str]:
    """The grep-stable prefix of the ``[tenancy]`` line, JAX's fields."""
    return eng.tenancy.summary_line().split()[:5]


def lists(eng) -> dict:
    st = eng.tenancy.stats()
    out = {k: st[k] for k in ("tenants", "resident", "resident_bytes",
                              "budget_bytes", "baked", "baked_bytes",
                              "swaps", "evictions", "rematerializations")}
    out["retired_pinned"] = [(p["tenant"], p["nbytes"])
                             for p in st["retired_pinned"]]
    return out


def both(scenario):
    """``scenario(side)`` -> (observations, answers) on both sides:
    the observations equal, the answers within ``TOY_TOL``."""
    (jo, ja), (po, pa) = (scenario(s) for s in SIDE_NAMES)
    assert jo == po, (jo, po)
    assert len(ja) == len(pa)
    for j, p in zip(ja, pa):
        np.testing.assert_allclose(j, p, atol=TOY_TOL)
    return po


def wait_until(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------- residency / LRU


def test_lru_eviction_under_budget_and_bit_equal_remat():
    def scenario(side):
        obs, ans = [], []
        with engine(side, [toy(side, "a", 2.0), toy(side, "b", 3.0)],
                    residency_bytes=4) as eng:
            x = _x(1)
            ra1 = eng.submit(x, model="a").result(timeout=30)
            rb1 = eng.submit(x, model="b").result(timeout=30)
            st = eng.tenancy.stats()
            assert st["budget_bytes"] == 4 and len(st["resident"]) == 1
            assert st["evictions"] >= 1
            obs += [counters(eng), lists(eng)]
            ra2 = eng.submit(x, model="a").result(timeout=30)
            assert ra2 == ra1  # bit for bit after the restore
            assert eng.tenancy.stats()["resident"] == ["a"]
            rb2 = eng.submit(x, model="b").result(timeout=30)
            assert rb2 == rb1
            obs += [counters(eng), lists(eng)]
            np.testing.assert_allclose(ra1["y"], expected(x, 2.0),
                                       atol=TOY_TOL)
            ans += [ra1["y"], rb1["y"]]
        return obs, ans

    obs = both(scenario)
    assert obs[3]["rematerializations"] >= 1


def test_explicit_evict_frees_bytes_and_waits_out_a_batch_in_flight():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)]) as eng:
            x = _x(2)
            r0 = eng.submit(x, model="a").result(timeout=30)
            assert eng.tenancy.resident_bytes() == 4
            if side == "port":
                # a batch in flight over the edition: the eviction waits
                # until its runner is unpinned
                runner = eng._bucket_runner(eng._models["a"], 1)
                eng.tenancy.pin(runner)
                t = threading.Thread(target=eng.tenancy.evict, args=("a",))
                t.start()
                t.join(0.2)
                assert t.is_alive()
                assert eng.tenancy.stats()["resident"] == ["a"]
                eng.tenancy.unpin(runner)
                t.join(30)
                assert not t.is_alive()
                # its runners left the cache with the weights
                assert eng.tenancy.stats()["dropped_runners"] == 2
            else:
                eng.tenancy.evict("a")
            assert eng.tenancy.resident_bytes() == 0
            assert eng.tenancy.stats()["resident"] == []
            r1 = eng.submit(x, model="a").result(timeout=30)
            assert r1 == r0
            np.testing.assert_allclose(r1["y"], expected(x, 2.0),
                                       atol=TOY_TOL)
            return [counters(eng), lists(eng)], [r1["y"]]

    obs = both(scenario)
    assert obs[1]["rematerializations"] == 1


def test_lone_tenant_never_evicted_below_budget():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)], residency_bytes=4) as eng:
            ans = [eng.submit(_x(i), model="a").result(timeout=30)["y"]
                   for i in range(3)]
            st = eng.tenancy.stats()
            assert st["evictions"] == 0 and st["resident"] == ["a"]
            return [counters(eng), lists(eng)], ans

    both(scenario)


# ------------------------------------------------------------ hot swap


def test_hot_swap_flips_exactly_once_and_drops_nothing():
    """Under three submitting threads every request answers, each answer
    is the old weights' or the new weights' whole, and the flip happens
    once (on both sides; how many answers each edition gave is
    timing)."""
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)], max_queue=512) as eng:
            x = _x(3)
            old, new = expected(x, 2.0), expected(x, 5.0)
            results, errors = [], []
            stop = threading.Event()

            def pound():
                while not stop.is_set():
                    try:
                        results.append(eng.submit(x, model="a")
                                       .result(timeout=30))
                    except Exception as e:  # a drop is a bug
                        errors.append(e)

            threads = [threading.Thread(target=pound) for _ in range(3)]
            for t in threads:
                t.start()
            wait_until(lambda: len(results) >= 6, msg="load on the old")
            res = eng.hot_swap("a", weights(side, 5.0))
            n = len(results)
            wait_until(lambda: len(results) >= n + 6, msg="load on the new")
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors, errors[:3]
            got = {tuple(r["y"]) for r in results}
            assert len(got) <= 2
            for y in got:
                assert (np.allclose(y, old, atol=TOY_TOL)
                        or np.allclose(y, new, atol=TOY_TOL)), y
            assert any(np.allclose(y, new, atol=TOY_TOL) for y in got)
            r = eng.submit(x, model="a").result(timeout=30)
            return ([res["model"], res["fingerprint"] != res[
                "old_fingerprint"], counters(eng), lists(eng)],
                    [r["y"]])

    both(scenario)


def test_concurrent_hot_swaps_serialize_to_final_weights():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)]) as eng:
            x = _x(4)
            eng.submit(x, model="a").result(timeout=30)
            ts = [threading.Thread(target=eng.hot_swap,
                                   args=("a", weights(side, w)))
                  for w in (5.0, 7.0)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            final = eng.submit(x, model="a").result(timeout=30)["y"]
            assert (np.allclose(final, expected(x, 5.0), atol=TOY_TOL)
                    or np.allclose(final, expected(x, 7.0), atol=TOY_TOL))
            return [counters(eng), lists(eng)], []

    assert both(scenario)[1]["swaps"] == 2


def test_same_fingerprint_swap_is_noop_and_keeps_serving():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)], freeze_cache=True) as eng:
            x = _x(5)
            keys = [eng._model_key(eng._models["a"], b) for b in (1, 4)]
            res = eng.hot_swap("a", weights(side, 2.0))  # the same bytes
            assert res["unchanged"] is True
            assert res["fingerprint"] == res["old_fingerprint"]
            assert all(eng._cache.contains(k) for k in keys)
            r = eng.submit(x, model="a").result(timeout=30)
            return ([res["dropped_executables"], counters(eng), lists(eng)],
                    [r["y"]])

    assert both(scenario)[2]["swaps"] == 0


def test_retried_swap_after_real_swap_is_noop():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)], freeze_cache=True) as eng:
            x = _x(6)
            eng.hot_swap("a", weights(side, 5.0))
            res = eng.hot_swap("a", weights(side, 5.0))  # the retry
            assert res["unchanged"] is True
            r = eng.submit(x, model="a").result(timeout=30)
            np.testing.assert_allclose(r["y"], expected(x, 5.0),
                                       atol=TOY_TOL)
            return [counters(eng), lists(eng)], [r["y"]]

    assert both(scenario)[1]["swaps"] == 1


def test_swap_surfaces_editions_pinned_by_live_runners():
    """A runner that outlives the swap (in production a DAG's graph)
    holds the old edition: stats count its bytes exactly as long."""
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)]) as eng:
            served = eng._models["a"]
            eng.submit(_x(7), model="a").result(timeout=30)
            pinned = eng._bucket_runner(served, 1)  # stands in for a DAG
            eng.hot_swap("a", weights(side, 5.0))
            during = lists(eng)
            del pinned
            gc.collect()
            return [during, lists(eng)], []

    during, after = both(scenario)
    assert during["retired_pinned"] == [("a", 4)]
    assert during["resident_bytes"] == 8
    assert after["retired_pinned"] == [] and after["resident_bytes"] == 4


def test_hot_swap_rejects_bad_args_like_jax():
    def scenario(side):
        errors = []
        with engine(side, [toy(side, "a", 2.0)]) as eng:
            for args, kw in ((("ghost", weights(side, 1.0)), {}),
                             (("a",), {}),
                             (("a", weights(side, 1.0)), {"perturb": 0.1})):
                with pytest.raises(ValueError) as e:
                    eng.hot_swap(*args, **kw)
                errors.append("unknown model" if "unknown model" in str(
                    e.value) else "exactly one" if "exactly one" in str(
                    e.value) else str(e.value))
        return [errors], []

    assert both(scenario)[0] == ["unknown model", "exactly one",
                                 "exactly one"]


def test_hot_swap_refuses_pipelines_trackers_and_artifacts(tmp_path):
    from deepvision_tpu_torch.export import export_forward, save_exported

    det, pose = port_detector(), port_pose()
    pipe = Pipeline(PipelineSpec.from_json(detpose_json()),
                    {"det": det, "pose": pose})
    track = TrackingPipeline("track", det, SessionStore(
        capacity=4, snapshot_dir=tmp_path / "snaps", registry=Registry()),
        slots=2)
    module = load_served("lenet5", device="cpu").module
    art = tmp_path / "lenet.pt2"
    save_exported(art, export_forward(
        module, np.zeros((1, 32, 32, 1), np.float32)))
    artifact = port_models.from_exported(art, name="art", device="cpu")
    with engine("port", [det, pose, track, artifact], buckets=(1,),
                pipelines=[pipe]) as eng:
        for name, what in (("detpose", "pipeline"),
                           ("track", "stateful wrapper"),
                           ("art", "torch.export artifact")):
            with pytest.raises(ValueError, match=what):
                eng.hot_swap(name, perturb=0.1)


# ------------------------------------- cache keys across a swap


def test_cache_keys_pin_weights_fingerprint_and_miss_on_swap():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)]) as eng:
            m = eng._models["a"]
            old_keys = [eng._model_key(m, b) for b in (1, 4)]
            for k in old_keys:
                assert len(k) == 4 and k[3] == m.weights_fingerprint()
                assert eng._cache.contains(k)
            res = eng.hot_swap("a", weights(side, 5.0))
            new_keys = [eng._model_key(m, b) for b in (1, 4)]
            for k_old, k_new in zip(old_keys, new_keys):
                assert k_new[3] == res["fingerprint"] != k_old[3]
                assert eng._cache.contains(k_new)
                assert not eng._cache.contains(k_old)
            misses = eng._cache.stats()["misses"]
            x = _x(8)
            r = eng.submit(x, model="a").result(timeout=30)
            np.testing.assert_allclose(r["y"], expected(x, 5.0),
                                       atol=TOY_TOL)
            assert eng._cache.stats()["misses"] == misses
            return [res["dropped_executables"], counters(eng)], [r["y"]]

    assert both(scenario)[0] == 2


def test_swap_works_on_frozen_cache():
    def scenario(side):
        with engine(side, [toy(side, "a", 2.0)], freeze_cache=True) as eng:
            x = _x(9)
            eng.hot_swap("a", weights(side, 4.0))
            r = eng.submit(x, model="a").result(timeout=30)
            np.testing.assert_allclose(r["y"], expected(x, 4.0),
                                       atol=TOY_TOL)
            return [counters(eng), lists(eng)], [r["y"]]

    both(scenario)


def test_eviction_on_a_frozen_cache_recaptures_without_a_miss():
    """The port's own half: an eviction drops the runners, and the
    restore installs their recaptures, so a frozen cache never misses."""
    with engine("port", [port_toy("a", 2.0), port_toy("b", 3.0)],
                residency_bytes=4, freeze_cache=True) as eng:
        x = _x(10)
        misses = eng.stats()["cache"]["misses"]
        for name in ("a", "b", "a", "b"):
            eng.submit(x, model=name).result(timeout=30)
        st = eng.stats()
        assert st["cache"]["misses"] == misses
        assert st["tenancy"]["recaptures"] == 2 * 4  # 2 buckets a restore
        line = eng.tenancy.summary_line()
        assert "recaptures=8 recapture_s=" in line, line


# ------------------------------------------------ per-tenant isolation


def test_tenant_quota_sheds_only_the_noisy_tenant():
    def scenario(side):
        shed_error = JaxShedError if side == "jax" else ShedError
        with engine(side, [toy(side, "a", 2.0), toy(side, "b", 3.0)],
                    max_queue=64, tenant_quota={"a": 2}) as eng:
            eng.pause()
            for _ in range(2):
                eng.submit(np.zeros(3, np.float32), model="a")
            with pytest.raises(shed_error, match="admission quota"):
                eng.submit(np.zeros(3, np.float32), model="a")
            f = eng.submit(np.ones(3, np.float32), model="b")
            eng.resume()
            y = f.result(timeout=30)["y"]
            queue = eng.stats()["queue"]
            return [queue["sheds_by_tenant"], queue["tenant_quota"]], [y]

    assert both(scenario)[0] == {"a": 1}


def test_slo_class_rations_queue_only_under_contention():
    def scenario(side):
        cls, shed_error = ((JaxAdmission, JaxShedError) if side == "jax"
                           else (AdmissionController, ShedError))
        adm = cls(max_queue=10, slo_class={"batch_t": "batch"})
        for _ in range(10):  # alone: the whole queue
            adm.admit("batch_t")
        for _ in range(10):
            adm.release("batch_t")
        adm.admit("gold_t")  # contended: batch holds at most half
        for _ in range(5):
            adm.admit("batch_t")
        with pytest.raises(shed_error, match="contended share") as e:
            adm.admit("batch_t")
        st = adm.stats()
        return [str(e.value), st["sheds_by_tenant"], st["slo_class"]], []

    assert both(scenario)[1] == {"batch_t": 1}


@pytest.mark.parametrize("kw,match", [
    ({"slo_class": {"t": "platinum"}}, "unknown SLO class"),
    ({"tenant_quota": {"t": 0}}, "quota must be >= 1")])
def test_admission_rejects_unknown_slo_class_and_bad_quota(kw, match):
    for cls in (JaxAdmission, AdmissionController):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


# ------------------------------------------------------ artifact store


def test_store_keys_include_fingerprint_and_swap_exports_new(tmp_path):
    def scenario(side):
        store = tmp_path / side
        with engine(side, [toy(side, "a", 2.0)], store=str(store)) as eng:
            old_fp = eng._models["a"].weights_fingerprint()
            res = eng.hot_swap("a", weights(side, 6.0))
            entries = eng._store.entries()
            fps = {e["fingerprint"] for e in entries.values()}
            assert {old_fp, res["fingerprint"]} <= fps
            n_entries = len(entries)
        # a respawn after the swap warms the new weights from the disk
        with engine(side, [toy(side, "a", 6.0)], store=str(store)) as eng2:
            warmed = eng2.stats()["warmed_from_store"]
            x = _x(11)
            r = eng2.submit(x, model="a").result(timeout=30)
            np.testing.assert_allclose(r["y"], expected(x, 6.0),
                                       atol=TOY_TOL)
        return [n_entries, warmed], [r["y"]]

    assert both(scenario)[1] == ["a@1", "a@4"]


def test_store_warmed_tenant_releases_edition_copy(tmp_path):
    def scenario(side):
        store = tmp_path / side
        x = _x(12)
        with engine(side, [toy(side, "a", 2.0)], store=str(store)) as eng:
            r1 = eng.submit(x, model="a").result(timeout=30)
        with engine(side, [toy(side, "a", 2.0)], store=str(store)) as eng2:
            before = lists(eng2)
            r2 = eng2.submit(x, model="a").result(timeout=30)
            assert r2 == r1
            remat = eng2.tenancy.stats()["rematerializations"]
            eng2.hot_swap("a", weights(side, 5.0))
            after = lists(eng2)
            warmed = eng2.stats()["warmed_from_store"]
            r3 = eng2.submit(x, model="a").result(timeout=30)
            np.testing.assert_allclose(r3["y"], expected(x, 5.0),
                                       atol=TOY_TOL)
        return [before, remat, after, warmed], [r1["y"], r3["y"]]

    before, remat, after, warmed = both(scenario)
    assert before["baked"] == ["a"] and before["baked_bytes"] == 8
    assert before["resident"] == [] and before["resident_bytes"] == 0
    assert remat == 0
    assert after["baked"] == [] and after["resident"] == ["a"]
    assert warmed == []


# ---------------------------------------- a real model through the op


SIZE, CLASSES = 64, 10


def test_alexnet_residency_and_perturb_swap_match_jax():
    """``alexnet1`` (two LRNs, the ``deepvision::lrn_forward`` op) with
    the JAX weights: the same weight bytes, and probabilities within
    ``REAL_TOL`` of the JAX engine's before, after an eviction and
    restore (bit for bit the port's own before) and after the same
    ``perturb`` swap, whose nudged weights equal JAX's bit for bit. The
    nudge saturates the fresh model's softmax (probabilities 1 and 0),
    so the classes are compared where their probabilities are untied
    (the order among tied ones is each top-k's own)."""
    jserved = jax_load_served("alexnet1", input_size=SIZE,
                              num_classes=CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jserved.variables)
    served = load_served("alexnet1", variables=variables, device="cpu",
                         input_size=SIZE, num_classes=CLASSES)
    assert tree_nbytes(state_tree(served.module)) \
        == jax_tree_nbytes(jserved.variables)
    xs = np.random.default_rng(13).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    out = {}
    with JaxEngine([jserved], mesh=create_mesh(1, 1), buckets=(1,)) as jeng, \
            engine("port", [served], buckets=(1,)) as peng:
        for label in ("before", "restored", "swapped"):
            if label == "restored":
                for eng in (jeng, peng):
                    eng.tenancy.evict("alexnet1")
            if label == "swapped":
                for eng in (jeng, peng):
                    eng.hot_swap("alexnet1", perturb=0.01)
            out[label] = [[eng.submit(x, model="alexnet1")
                           .result(timeout=120) for x in xs]
                          for eng in (jeng, peng)]
        assert counters(jeng) == counters(peng)
        assert peng.tenancy.stats()["recaptures"] == 1
        nudged = jax.tree_util.tree_map(
            np.asarray, jeng._models["alexnet1"].edition.variables)
        mine = state_tree(peng._models["alexnet1"].module)
        assert jax.tree_util.tree_structure(nudged) \
            == jax.tree_util.tree_structure(mine)
        for a, b in zip(jax.tree_util.tree_leaves(nudged),
                        jax.tree_util.tree_leaves(mine)):
            np.testing.assert_array_equal(a, b)
    assert out["restored"][1] == out["before"][1]  # bit for bit
    assert out["swapped"][1] != out["before"][1]
    for label, (jax_ans, port_ans) in out.items():
        for j, p in zip(jax_ans, port_ans):
            np.testing.assert_allclose(j["probs"], p["probs"],
                                       atol=REAL_TOL, err_msg=label)
            untied = [i for i, v in enumerate(j["probs"])
                      if j["probs"].count(v) == 1]
            assert untied, label
            assert [j["classes"][i] for i in untied] \
                == [p["classes"][i] for i in untied], label
    # before the nudge nothing is tied
    assert all(len(set(a["probs"])) == 5 for a in out["before"][0])


def test_hot_swap_from_a_workdir_serves_its_checkpoint(tmp_path):
    """``hot_swap(workdir=)`` (the swap control's ``"workdir"``) serves the
    newest verified checkpoint under ``{workdir}/ckpt``: the answers of
    ``load_served`` from the same directory, bit for bit."""
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState

    cfg = get_config("lenet5")
    module = create_model("lenet5", device=torch.device("cpu"), seed=7,
                          num_classes=cfg["num_classes"],
                          input_size=cfg["input_size"])
    opt, _ = make_optimizer(cfg, module.parameters(), steps_per_epoch=1)
    wd = tmp_path / "lenet5"
    CheckpointManager(wd / "ckpt").save(0, TrainState(module, opt),
                                        config=cfg)
    x = np.random.default_rng(18).normal(size=(32, 32, 1)).astype(
        np.float32)
    want = load_served("lenet5", str(wd), device="cpu")
    want = want.postprocess(want.run(x[None]), 0)
    with engine("port", [load_served("lenet5", device="cpu")],
                buckets=(1,)) as eng:
        before = eng.submit(x, model="lenet5").result(timeout=30)
        res = eng.hot_swap("lenet5", workdir=str(wd))
        after = eng.submit(x, model="lenet5").result(timeout=30)
    assert res["fingerprint"] != res["old_fingerprint"]
    assert after == want != before
    shutil.rmtree(wd)  # the workers share one temporary disk


# ------------------------------------------------- DAG and tracker stages


class _Weight(torch.nn.Module):
    def __init__(self, w: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w), requires_grad=False)


_TOY_BOXES = [[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.9],
              [0.0, 0.0, 1.0, 1.0]]


def _det_forward(mod):
    def forward(x):
        b = x.shape[0]
        base = torch.tanh(torch.mean(x, dim=(1, 2, 3))) * 1e-3
        boxes = torch.tensor(_TOY_BOXES, device=x.device).expand(b, 3, 4)
        scores = torch.stack([base + 0.9, base + 0.6, base + 0.1], dim=1)
        return {"boxes": boxes * mod.w, "scores": scores,
                "classes": torch.zeros((b, 3), dtype=torch.int32,
                                       device=x.device),
                "valid": scores > 0.5}

    return forward


def port_detector(weight=1.0) -> ServedModel:
    """``tests/test_pipeline.py``'s detect toy, its weight a parameter."""
    mod = _Weight(weight)
    return ServedModel(name="det", task="detect", module=mod,
                       input_shape=(16, 16, 3),
                       postprocess=port_models._detect_post,
                       device=torch.device("cpu"), forward=_det_forward(mod),
                       make_forward=_det_forward)


def _pose_forward(mod):
    def forward(x):
        m = torch.mean(x, dim=(1, 2, 3)) * mod.w
        kx = torch.stack([m, m * 2], dim=1)
        return {"x": kx, "y": kx + 1, "conf": kx * 0 + 0.8}

    return forward


def port_pose() -> ServedModel:
    mod = _Weight(1.0)
    return ServedModel(name="pose", task="pose", module=mod,
                       input_shape=(8, 8, 3),
                       postprocess=port_models._pose_post,
                       device=torch.device("cpu"), forward=_pose_forward(mod),
                       make_forward=_pose_forward)


def _dag_engine(side, **kw):
    spec = detpose_json()
    if side == "jax":
        models = {"det": jax_toy_detector(), "pose": jax_toy_pose()}
        pipe = jax_pipeline.Pipeline(
            jax_pipeline.PipelineSpec.from_json(spec), models)
        return JaxEngine(list(models.values()), mesh=create_mesh(1, 1),
                         buckets=(1, 4), pipelines=[pipe],
                         freeze_cache=True, **kw)
    models = {"det": port_detector(), "pose": port_pose()}
    pipe = Pipeline(PipelineSpec.from_json(spec), models)
    return engine("port", list(models.values()), pipelines=[pipe],
                  freeze_cache=True, **kw)


def _flat(answer) -> list:
    """A DAG or detect answer's numbers, in order."""
    if isinstance(answer, dict):
        return [v for k in sorted(answer) for v in _flat(answer[k])]
    if isinstance(answer, list):
        return [v for a in answer for v in _flat(a)]
    return [float(answer)]


def test_dag_stage_eviction_recaptures_and_swap_keeps_old_weights():
    """The ``detpose`` DAG over the detector: an eviction of ``det``
    drops the DAG's graphs with its own, and the DAG's next request
    recaptures them (``install``: the frozen cache's misses stay) and
    answers as before; a swap of ``det`` moves its front door to the new
    weights while the DAG keeps the old ones, its edition counted as
    retired and pinned, as in the JAX engine."""
    xs = np.random.default_rng(14).normal(
        size=(2, 16, 16, 3)).astype(np.float32)

    def scenario(side):
        with _dag_engine(side) as eng:
            dag0 = [eng.submit(x, model="detpose").result(timeout=60)
                    for x in xs]
            misses = eng.stats()["cache"]["misses"]
            eng.tenancy.evict("det")
            if side == "port":
                # the detector's 2 buckets and the DAG's 2 entry buckets
                assert eng.tenancy.stats()["dropped_runners"] == 4
            dag1 = [eng.submit(x, model="detpose").result(timeout=60)
                    for x in xs]
            assert dag1 == dag0
            assert eng.stats()["cache"]["misses"] == misses
            eng.hot_swap("det", weights_dag(side, 2.0))
            dag2 = [eng.submit(x, model="detpose").result(timeout=60)
                    for x in xs]
            front = [eng.submit(x, model="det").result(timeout=60)
                     for x in xs]
            assert dag2 == dag0  # the DAG keeps the old weights
            for f in front:  # the front door has the new ones
                assert max(max(b) for b in f["boxes"]) == pytest.approx(
                    2.0 * 0.9)
            st = lists(eng)
            if side == "port":
                assert eng.tenancy.stats()["recaptures"] == 4
            return ([counters(eng), st["retired_pinned"][0][0],
                     st["resident"]],
                    [_flat(a) for a in dag0 + dag2 + front])

    obs = both_tol(scenario, DAG_TOL)
    assert obs[1] == "det"


def weights_dag(side, w):
    if side == "jax":
        return {"w": np.float32(w)}
    return {"params": {"w": np.float32(w)}}


def both_tol(scenario, tol):
    (jo, ja), (po, pa) = (scenario(s) for s in SIDE_NAMES)
    assert jo == po, (jo, po)
    for j, p in zip(ja, pa, strict=True):
        np.testing.assert_allclose(j, p, atol=tol)
    return po


def test_tracker_detector_eviction_recaptures_its_graphs(tmp_path):
    """A ``TrackingPipeline`` over a detector with weights: evicting the
    detector drops the tracker's runners with the detector's own; the
    next frame re-installs them (no miss on the frozen cache), and a
    fresh stream answers frame for frame as a stream did before."""
    det = port_detector()
    track = TrackingPipeline("track", det, SessionStore(
        capacity=8, snapshot_dir=tmp_path / "snaps", registry=Registry()),
        slots=2, detect_every=2)
    frames = np.random.default_rng(15).normal(
        size=(4, 16, 16, 3)).astype(np.float32)
    with engine("port", [det, track], buckets=(1,),
                freeze_cache=True) as eng:
        def stream(sid):
            return [eng.submit(f, model="track", session=sid, seq=i)
                    .result(timeout=60) for i, f in enumerate(frames)]

        before = stream("s0")
        misses = eng.stats()["cache"]["misses"]
        assert eng.tenancy.evict("det")
        assert eng.tenancy.stats()["dropped_runners"] == 2
        after = stream("s1")
        for a, b in zip(before, after, strict=True):
            assert {k: v for k, v in a.items() if k != "session"} \
                == {k: v for k, v in b.items() if k != "session"}
        st = eng.stats()
        assert st["cache"]["misses"] == misses
        assert st["tenancy"]["recaptures"] == 2
        assert st["tenancy"]["rematerializations"] == 1
        assert st["tenancy"]["tenants"] == ["det"]


# ------------------------------------------------ CLI, fleet and HTTP


def test_parse_tenant_map_exits_like_serve_py():
    for specs, cast in ((["lenet5=8", "b=2"], int), (["a=gold"], str)):
        assert port_cli._parse_tenant_map(specs, flag="--f", cast=cast) \
            == jax_serve_cli._parse_tenant_map(specs, flag="--f", cast=cast)
    assert port_cli._parse_tenant_map(None, flag="--f", cast=int) is None
    for bad in (["nosep"], ["=3"], ["a=x"]):
        messages = []
        for parse in (port_cli._parse_tenant_map,
                      jax_serve_cli._parse_tenant_map):
            with pytest.raises(SystemExit) as e:
                parse(bad, flag="--tenant-quota", cast=int)
            messages.append(str(e.value))
        assert messages[0] == messages[1], messages
        assert "--tenant-quota" in messages[0]


def test_cli_stdin_swap_control_and_tenancy_exit_line():
    """Two tenants under a budget that holds one, a stdin stream with a
    swap control line: every data line answered, ``lenet5``'s answers
    from both editions, ``dcgan``'s untouched, a request answered the
    same before an eviction and after its restore, and the ``[tenancy]``
    line with the swap, evictions and restores."""
    sizes = {n: tree_nbytes(state_tree(load_served(n, device="cpu").module))
             for n in ("lenet5", "dcgan")}
    budget_mb = max(sizes.values()) / 2 ** 20 * 1.01
    assert budget_mb * 2 ** 20 < sum(sizes.values())
    rng = np.random.default_rng(16)
    img = rng.normal(size=(32, 32, 1)).astype(np.float32).tolist()
    z = rng.normal(size=100).astype(np.float32).tolist()
    err = io.StringIO()

    def stream():
        for i in range(2):  # lenet5, dcgan, lenet5 again
            yield json.dumps({"id": i, "model": "lenet5", "input": img})
            yield json.dumps({"id": 100 + i, "model": "dcgan", "input": z})
        yield json.dumps({"control": "swap", "model": "lenet5",
                          "perturb": 0.01})
        wait_until(lambda: "[tenancy] swapped lenet5" in err.getvalue(),
                   timeout=120, msg="the swap")
        for i in range(2):
            yield json.dumps({"id": 200 + i, "model": "lenet5",
                              "input": img})
        yield json.dumps({"id": 300, "model": "dcgan", "input": z})

    out = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port_cli.main(
            ["-m", "lenet5", "-m", "dcgan", "--device", "cpu", "--buckets",
             "1", "--residency-mb", f"{budget_mb:.6f}", "--tenant-quota",
             "dcgan=4", "--slo-class", "lenet5=batch"],
            stdin=(line + "\n" for line in stream()), stdout=out)
    assert rc == 0
    replies = {r["id"]: r["result"] for r in
               map(json.loads, out.getvalue().splitlines())}
    assert sorted(replies) == [0, 1, 100, 101, 200, 201, 300]
    # before an eviction and after its restore: the same bits
    assert replies[0] == replies[1]
    assert replies[100] == replies[101] == replies[300]
    assert replies[200] == replies[201] != replies[0]  # the new edition
    lines = err.getvalue().strip().splitlines()
    assert lines[-1].startswith("[serve] completed=7 ")
    tenancy = lines[-2]
    assert tenancy.startswith("[tenancy] swaps=1 evictions="), tenancy
    fields = dict(kv.split("=") for kv in tenancy.split()[1:])
    assert int(fields["evictions"]) >= 1
    assert int(fields["rematerializations"]) >= 1
    assert fields["resident"].endswith("/2")


def test_fleet_forwards_the_tenancy_flags(monkeypatch):
    """``--fleet``: every child gets ``--residency-mb``, the quotas and
    the classes, and the router's admission gate gets the maps."""
    from deepvision_tpu_torch.serve import replica as replica_mod
    from deepvision_tpu_torch.serve import router as router_mod

    seen = {}

    class _Router:
        def __init__(self, factory, **kw):
            seen["router"] = kw
            seen["child"] = factory("r0")

        def health(self):
            return {}

    monkeypatch.setattr(replica_mod, "ProcessReplica",
                        lambda sid, argv: argv)
    monkeypatch.setattr(router_mod, "FleetRouter", _Router)
    ns = SimpleNamespace(
        model=["lenet5"], artifact=None, track=None, pipelines=None,
        store=None, device="cpu", buckets="1", seed=0, input_size=None,
        num_classes=None, top=5, score=0.5, iou=0.5, max_queue=64,
        batch_window_ms=2.0, timeout_s=30.0, residency_mb=12.5,
        per_model_limit=None,
        tenant_quota=["lenet5=3"], slo_class=["lenet5=gold"], faults=None,
        slo=None, fleet=2, fleet_max=None, hedge_after=None,
        session_replay_window=32, session_dir=None)
    port_cli.build_fleet(ns)
    argv = seen["child"]
    for flag, value in (("--residency-mb", "12.5"),
                        ("--tenant-quota", "lenet5=3"),
                        ("--slo-class", "lenet5=gold")):
        assert argv[argv.index(flag) + 1] == value, argv
    assert seen["router"]["tenant_quota"] == {"lenet5": 3}
    assert seen["router"]["slo_class"] == {"lenet5": "gold"}


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@contextlib.contextmanager
def _http_front(front):
    server = make_server(("127.0.0.1", 0),
                         make_handler(front, SimpleNamespace(timeout_s=30.0)))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


def test_http_swap_answers_200_on_an_engine_and_404_on_a_fleet():
    x = _x(17)
    with engine("port", [port_toy("a", 2.0)]) as eng, \
            _http_front(eng) as port:
        code, body = _post(port, "/v1/swap", {"model": "a",
                                              "perturb": 1.0})
        assert code == 200, body
        assert body["result"]["fingerprint"] != \
            body["result"]["old_fingerprint"]
        code, ans = _post(port, "/v1/predict",
                          {"model": "a", "input": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(ans["result"]["y"], expected(x, 3.0),
                                   atol=TOY_TOL)
        assert _post(port, "/v1/swap", {"perturb": 1.0})[0] == 400
        assert _post(port, "/v1/swap", {"model": "ghost",
                                        "perturb": 1.0})[0] == 400
        assert eng.tenancy.swaps == 1
    router_mod, replica_mod, _ = SIDES["port"]
    fleet = router_mod.FleetRouter(
        lambda sid: FakeReplica(sid, replica_mod.ReplicaDeadError),
        replicas=1, models=["a"], probe_interval_s=0.03)
    try:
        with _http_front(fleet) as port:
            code, body = _post(port, "/v1/swap", {"model": "a",
                                                  "perturb": 1.0})
        assert code == 404 and "fleet" in body["error"]
    finally:
        fleet.close()


class _GatedReplica(FakeReplica):
    """A scripted replica whose requests wait for ``gate``."""

    gate = threading.Event()

    def request(self, model, x, *, timeout_s=None, trace=None):
        self.gate.wait(30)
        return super().request(model, x, timeout_s=timeout_s, trace=trace)


def test_router_sheds_by_tenant_like_jax():
    def scenario(side):
        router_mod, replica_mod, _ = SIDES[side]
        _GatedReplica.gate = threading.Event()
        fleet = router_mod.FleetRouter(
            lambda sid: _GatedReplica(sid, replica_mod.ReplicaDeadError),
            replicas=1, models=["a", "b"], probe_interval_s=0.03,
            tenant_quota={"a": 1}, slo_class={"b": "gold"})
        try:
            first = fleet.submit(np.zeros(2, np.float32), model="a")
            with pytest.raises(ShedError if side == "port"
                               else JaxShedError, match="admission quota"):
                fleet.submit(np.zeros(2, np.float32), model="a")
            other = fleet.submit(np.ones(2, np.float32), model="b")
            _GatedReplica.gate.set()
            answers = [first.result(timeout=30)["echo"],
                       other.result(timeout=30)["echo"]]
            queue = fleet.stats()["queue"]
            return [queue["sheds_by_tenant"], queue["tenant_quota"],
                    queue["slo_class"]], [_flat(answers)]
        finally:
            _GatedReplica.gate.set()
            fleet.close()

    assert both(scenario)[0] == {"a": 1}
