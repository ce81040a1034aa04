"""The port's ragged front end (``serve/ragged.py``) against the JAX
package's, on the CPU: the batch rungs, ``solve_ragged`` on
``tests/test_serve.py``'s requests (order, buckets, X, health), fault
isolation under ``nan_tile`` and ``singular_pivot``, ``verify=True``, an
unknown routine, and the serving counters and gauges, which must equal
the JAX package's for the same requests.

Inputs are made with numpy from a seed and go into both packages; X is
held to the JAX package's within 1e-9 (both solve the same embedding in
float64) and to ``numpy.linalg.solve`` within the JAX suite's 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
from slate_tpu import obs as jobs  # noqa: E402
from slate_tpu.robust import faults as jfaults  # noqa: E402
from slate_tpu.serve import ragged as jragged  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch import obs  # noqa: E402
from slate_tpu_torch.cache import buckets  # noqa: E402
from slate_tpu_torch.robust import abft, faults  # noqa: E402
from slate_tpu_torch.serve import (SolveRequest, batch_rungs,  # noqa: E402
                                   solve_ragged)
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

TABLE = (64, 128, 256)


@pytest.fixture(autouse=True)
def _isolated():
    """No fault from the environment, empty logs and metrics on in both
    packages for each test."""
    faults.clear_log()
    jfaults.clear_log()
    obs.reset()
    jobs.reset()
    obs.metrics_on()
    jobs.metrics_on()
    with faults.inject(), jfaults.inject():
        yield
    obs.metrics_off()
    jobs.metrics_off()


def prime_requests(cls):
    """tests/test_serve.py's round trip: prime orders, both routines, a
    2-D and a 1-D right-hand side."""
    reqs = []
    for n in (23, 37, 53, 97, 131):
        reqs.append(cls(a=spd(n, seed=n), b=rand(n, 1, seed=n),
                        routine="posv", tag=("posv", n)))
        reqs.append(cls(a=rand(n, n, seed=2 * n) + n * np.eye(n),
                        b=rand(n, 2, seed=3 * n)[:, 0], routine="gesv",
                        tag=("gesv", n)))
    return reqs


def fault_requests(cls):
    return [cls(a=spd(n, seed=n), b=np.ones(n), tag=n)
            for n in (40, 45, 50, 55, 60)]


def test_batch_rungs_match_jax():
    assert batch_rungs(21) == [16, 4, 1]
    for c in range(-1, 70):
        assert batch_rungs(c) == jragged.batch_rungs(c)
        assert sum(batch_rungs(c)) == max(c, 0)


def test_solve_ragged_matches_jax():
    reqs = prime_requests(SolveRequest)
    res = solve_ragged(reqs, table=TABLE, nb=32, device="cpu")
    jres = jragged.solve_ragged(prime_requests(jragged.SolveRequest),
                                table=TABLE, nb=32)
    assert [r.tag for r in res] == [q.tag for q in reqs]
    for q, r, j in zip(reqs, res, jres):
        n = q.a.shape[0]
        assert (r.tag, r.bucket, r.rung, r.n) == (j.tag, j.bucket, j.rung,
                                                  j.n)
        assert r.bucket == buckets.bucket_for(n, TABLE)
        assert r.health.ok and j.health.ok
        assert r.health.request_id == r.rid == q.rid
        assert isinstance(r.x, np.ndarray) and r.x.shape == q.b.shape
        assert np.abs(r.x - j.x).max() < 1e-9
        ref = np.linalg.solve(q.a, q.b.reshape(n, -1))
        assert np.abs(r.x.reshape(ref.shape) - ref).max() < 1e-9
        assert set(r.stages) == {"queue", "pack", "solve", "crop"}
        assert abs(sum(r.stages.values()) - (r.t_done - q.t_submit)) < 1e-3


@pytest.mark.parametrize("kind", ["nan_tile", "singular_pivot"])
def test_fault_isolated_to_one_member(kind):
    spec = f"{kind}:seed=2"
    routine = "posv" if kind == "nan_tile" else "gesv"
    reqs = fault_requests(SolveRequest)
    jreqs = fault_requests(jragged.SolveRequest)
    for r in reqs + jreqs:
        r.routine = routine
    with faults.inject(spec):
        res = solve_ragged(reqs, table=(64,), nb=32, device="cpu")
    with jfaults.inject(spec):
        jres = jragged.solve_ragged(jreqs, table=(64,), nb=32)
    bad = [r for r in res if not r.health.ok]
    assert len(bad) == 1 and bad[0].tag == 50     # the seed picks member 2
    assert [r.health.info for r in res] == [r.health.info for r in jres]
    assert [(f.kind, f.where) for f in faults.injection_log()] == \
        [(f.kind, f.where) for f in jfaults.injection_log()]
    for q, r in zip(reqs, res):
        assert np.isfinite(r.x).all()
        if r.health.ok:
            assert np.abs(r.x - np.linalg.solve(q.a, np.ones(r.n))).max() \
                < 1e-9


def test_verify_runs_the_residual_check():
    reqs = [SolveRequest(a=spd(n, seed=n), b=rand(n, 2, seed=n), tag=n,
                         verify=True) for n in (30, 50)]
    reqs.append(SolveRequest(a=spd(40, seed=4), b=np.ones(40), tag=40))
    res = solve_ragged(reqs, table=(64,), nb=32, device="cpu")
    jreqs = [jragged.SolveRequest(a=q.a, b=q.b, tag=q.tag, verify=q.verify)
             for q in reqs]
    jres = jragged.solve_ragged(jreqs, table=(64,), nb=32)
    for r, j in zip(res, jres):
        assert r.health.verified == j.health.verified
        if r.tag == 40:
            assert r.health.verified is None and r.rung == 1
        else:
            assert r.health.verified is True and r.rung == 2
            assert r.health.checksum_resid <= abft.tolerance("bf16_6x",
                                                             r.n)
            assert abs(r.health.checksum_resid - j.health.checksum_resid) \
                < 1e-15
    assert not abft.detection_log()
    ok, resid = abft.verify_solve("posv", np.eye(4), np.ones(4),
                                  np.zeros(4), "bf16_6x")
    assert not ok and resid > 0.1
    assert abft.detection_log()[-1].phase == "serve"
    assert obs.counter_value("abft.detect", routine="posv",
                             phase="serve") == 1
    abft.clear_detections()


def test_unknown_routine_and_rejected_order_raise():
    with pytest.raises(ValueError):
        solve_ragged([SolveRequest(a=spd(8), b=np.ones(8),
                                   routine="geqrf")], device="cpu")
    with pytest.raises(ValueError):
        solve_ragged([SolveRequest(a=spd(100), b=np.ones(100))],
                     table=(64,), policy="reject", device="cpu")


def _series(snap, kind, names):
    return sorted((e["name"], sorted(e["labels"].items()),
                   round(e["value"], 6)) for e in snap[kind]
                  if e["name"] in names)


def test_serving_metrics_match_jax():
    """serve.requests, serve.padded_flops, serve.real_flops and the
    padded-waste gauge under the same names, labels and values as the
    JAX package's; the latency and stage histograms count every request
    (their seconds differ by nature)."""
    reqs = prime_requests(SolveRequest)
    seen = []
    solve_ragged(reqs, table=TABLE, nb=32, device="cpu",
                 on_result=lambda q, r: seen.append(q.tag))
    jragged.solve_ragged(prime_requests(jragged.SolveRequest), table=TABLE,
                         nb=32)
    assert sorted(seen) == sorted(q.tag for q in reqs)
    snap, jsnap = obs.dump(), jobs.dump()
    names = {"serve.requests", "serve.padded_flops", "serve.real_flops"}
    assert _series(snap, "counters", names) == \
        _series(jsnap, "counters", names)
    assert _series(snap, "gauges", {"serve.padded_waste_frac"}) == \
        _series(jsnap, "gauges", {"serve.padded_waste_frac"})
    assert obs.counter_value("serve.requests", routine="posv", bucket="64",
                             ok="yes", tenant="default",
                             slo_class="standard", sched="direct") == 3
    for name, count in (("serve.latency_s", len(reqs)),
                        ("serve.stage_s", 4 * len(reqs))):
        assert sum(e["count"] for e in snap["histograms"]
                   if e["name"] == name) == count
        assert all(e["kind"] == "log" for e in snap["histograms"]
                   if e["name"] == name)
    # one dispatch span a chunk: 6 groups, the two of 3 members in 2 rungs
    spans = [sum(e["count"] for e in s["spans"]
                 if e["name"] == "serve.dispatch") for s in (snap, jsnap)]
    assert spans == [8, 8]


def test_metrics_off_records_nothing():
    obs.metrics_off()
    solve_ragged(fault_requests(SolveRequest), table=(64,), nb=32,
                 device="cpu")
    snap = obs.dump()
    assert not snap["counters"] and not snap["histograms"]
    assert not snap["spans"] and not snap["metrics_enabled"]


def test_env_fault_spec_parses_as_in_jax(monkeypatch):
    spec = "nan_tile:seed=3:target=posv, bogus, singular_pivot:seed=2"
    monkeypatch.setenv(faults.ENV, spec)
    with faults.inject("nan_tile"):
        assert [s.kind for s in faults.active()] == ["nan_tile"]
    faults._override = None
    jfaults._override = None
    assert faults.active() == tuple(
        faults.FaultSpec(s.kind, s.seed, s.target)
        for s in jfaults.active())
    assert faults.enabled("nan_tile", "posv").seed == 3
    assert faults.enabled("nan_tile", "gesv") is None
    assert faults.enabled("singular_pivot", "gesv").seed == 2


@pytest.mark.parametrize("spec", ["inf_tile", "bit_flip_tile:seed=1",
                                  "preempt:target=potrf",
                                  "singular_pivot:fires=2"])
def test_fault_spec_without_a_port_raises(spec):
    """A kind the JAX package arms but the port has no hook for, or a
    ``fires=`` count, raises where the JAX package would arm it."""
    jfaults.inject(spec)
    with pytest.raises(pst.SlateError, match="not ported"):
        faults.inject(spec)


def test_metrics_registry_matches_jax():
    """The same observations give the JAX package's snapshot: counters,
    gauges, the exact log-bucket histograms with their quantiles, and
    span aggregates."""
    vals = np.random.default_rng(3).lognormal(-6, 2, 700)
    for pkg in (obs, jobs):
        for v in vals:
            pkg.observe("serve.latency_s", v, routine="posv")
            pkg.observe("serve.stage_s", v, stage="pack")
        pkg.count("c", 2.5, k="x")
        pkg.gauge("g", 7.0)
        pkg.metrics.record_span_stat("s", 0.25, {"a": 1})
    mine, theirs = obs.metrics.snapshot(), jobs.metrics.snapshot()
    assert mine == theirs
