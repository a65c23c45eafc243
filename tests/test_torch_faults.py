"""Port parity for the serving fault-tolerance layer: ``serving/faults.py``
and the engine's hooks (the port of ``tests/test_faults.py``).

Every case of the reference runs on the port engine (CPU tensors, so the
kernels' plain versions) with the reference's assertions, and every
engine case runs again on the JAX engine (its Pallas kernels in
interpret mode) with the same bridged weights and the same injector
seed: the two must give the same ``injector.events``, the same terminal
status and output per rid, and the same round-clock counters.  Nothing
here has a tolerance: the schedule, the streams and the counters are
compared exactly.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.serving import faults as jax_faults
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import faults as pt_faults
from repro_torch.serving.engine import (
    CANCELLED, COMPLETED, FAILED, SHED, TERMINAL_STATUSES, TIMED_OUT,
    EngineStallError)
from repro_torch.serving.faults import (
    INJECTION_POINTS, FaultConfig, FaultInjector)
from repro_torch.serving.scheduler import (
    ADMITTED, REJECTED_QUEUE_FULL, SHED_UNMEETABLE_DEADLINE)

MAX_LEN = 64

# the round-clock counters both engines must agree on
COUNTERS = ("completed", "cancelled", "timed_out", "failed", "shed",
            "rejected", "quarantined", "retried", "slot_steps",
            "prefill_rounds", "decode_tokens", "wasted_slot_steps",
            "nonfinite_decode_rounds")


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_archs.smoke("mingru-lm")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pt_archs.smoke("mingru-lm"), jparams, pparams


def _engine(side, **kw):
    jcfg, pcfg, jparams, pparams = _pair()
    if side == "jax":
        return jax_engine.ServingEngine(jcfg, jparams, **kw)
    return pt_engine.ServingEngine(pcfg, pparams, device="cpu", **kw)


def _injector(side, **kw):
    mod = jax_faults if side == "jax" else pt_faults
    return mod.FaultInjector(**kw)


@functools.lru_cache(maxsize=None)
def _ref_stream(prompt, max_new):
    _, pcfg, _, pparams = _pair()
    return tuple(pt_engine.generate_one(pcfg, pparams, list(prompt),
                                        max_new=max_new, max_len=MAX_LEN,
                                        device="cpu"))


def _refs(prompts, max_new):
    return [list(_ref_stream(tuple(p), max_new)) for p in prompts]


def _check_identities(engine):
    """Extended slot-step identity + terminal accounting (drained)."""
    s = engine.stats
    tokens = s.non_spec_tokens if engine.draft is not None \
        else s.decode_tokens
    overlaps = len(s.ttft_rounds)
    assert s.slot_steps == (s.prefill_rounds + tokens - overlaps
                            + s.wasted_slot_steps
                            + s.nonfinite_decode_rounds)
    assert s.submitted == (s.completed + s.cancelled + s.timed_out
                           + s.failed + s.shed + s.rejected)
    for req in engine.requests.values():
        assert req.status in TERMINAL_STATUSES, (req.rid, req.status)


def _outcome(engine):
    """What the two engines must agree on, exactly."""
    return {
        "events": None if engine.faults is None
        else [tuple(e) for e in engine.faults.events],
        "requests": {rid: (r.status, list(r.out), r.verdict, r.retries)
                     for rid, r in sorted(engine.requests.items())},
        "counters": {c: getattr(engine.stats, c) for c in COUNTERS},
    }


def _same_as_jax(port, scenario):
    """Run ``scenario`` on the JAX engine and hold the port's outcome to
    it."""
    assert _outcome(port) == _outcome(scenario("jax"))


# ---------------------------------------------------------------------------
# Injector determinism + inertness (pure host logic, no model); the port's
# schedule equals the reference's draw for draw
# ---------------------------------------------------------------------------

def _drive(inj, calls=20):
    out = []
    for call in range(calls):
        out.append(tuple(inj.corrupt_state(call * 4, 4, 8)))
        out.append(tuple(inj.drop_upload(call, [0, 3, 5])[1]))
        out.append(inj.straggler(call) > 0)
    return out, list(inj.events)


def test_injector_same_seed_same_schedule():
    kw = dict(seed=11, nan_rate=0.05, drop_rate=0.3, straggler_rate=0.2)
    a, ev_a = _drive(FaultInjector(**kw))
    b, ev_b = _drive(FaultInjector(FaultConfig(**kw)))
    assert a == b and ev_a == ev_b
    c, _ = _drive(FaultInjector(seed=12, nan_rate=0.05, drop_rate=0.3,
                                straggler_rate=0.2))
    assert a != c
    assert any(ev_a)
    assert (a, ev_a) == _drive(jax_faults.FaultInjector(**kw))


def test_injector_zero_rates_inject_nothing():
    inj = FaultInjector(seed=0)
    for call in range(10):
        assert inj.corrupt_state(call, 4, 8) == []
        assert inj.drop_upload(call, [1, 2]) == ([1, 2], [])
        assert inj.straggler(call) == 0.0
    assert inj.events == []
    with pytest.raises(ValueError):
        FaultInjector(FaultConfig(seed=0), nan_rate=0.5)


def test_fault_config_rejects_out_of_range_rates():
    for kw in (dict(nan_rate=1.5), dict(drop_rate=-0.1),
               dict(straggler_rate=2.0), dict(straggler_s=-1.0)):
        with pytest.raises(ValueError):
            FaultConfig(**kw)
    FaultConfig(nan_rate=0.0, drop_rate=1.0)


def test_counts_keys_every_injection_point():
    counts = FaultInjector(seed=0).counts()
    assert set(counts) == set(INJECTION_POINTS)
    assert INJECTION_POINTS == jax_faults.INJECTION_POINTS
    assert counts["shard_crash"] == 0


def test_shard_crash_schedule_fires_once_per_shard():
    inj = FaultInjector(shard_crash_at=((5, 1), (5, 9), (11, 0)))
    assert inj.shard_crash(0, 4, 2) == []
    assert inj.shard_crash(4, 4, 2) == [1]
    assert inj.shard_crash(4, 4, 2) == []
    assert inj.shard_crash(8, 4, 2) == [0]
    assert inj.counts()["shard_crash"] == 2


def test_injector_state_dict_resumes_schedule():
    kw = dict(seed=9, nan_rate=0.2, drop_rate=0.3, straggler_rate=0.5)
    a = FaultInjector(**kw)
    ref = jax_faults.FaultInjector(**kw)
    for call in range(5):
        for inj in (a, ref):
            inj.corrupt_state(call * 4, 4, 8)
            inj.drop_upload(call, [0, 1, 2])
            inj.straggler(call)
    state = a.state_dict()
    b = FaultInjector(**kw)
    b.load_state_dict(state)
    for call in range(5, 10):
        assert a.corrupt_state(call * 4, 4, 8) == \
            b.corrupt_state(call * 4, 4, 8) == \
            ref.corrupt_state(call * 4, 4, 8)
        assert a.drop_upload(call, [0, 1, 2]) == \
            b.drop_upload(call, [0, 1, 2]) == ref.drop_upload(call, [0, 1, 2])
        assert a.straggler(call) == b.straggler(call) == ref.straggler(call)
    assert a.events == b.events == ref.events


def test_explicit_nan_schedule_targets_round_window():
    inj = FaultInjector(nan_at=((5, 1), (9, 0), (3, 99)))
    assert inj.corrupt_state(4, 4, 4) == [1]
    assert inj.corrupt_state(8, 4, 4) == [0]
    assert inj.corrupt_state(0, 2, 4) == []


# ---------------------------------------------------------------------------
# Fault-free path stays bit-identical (inert injector)
# ---------------------------------------------------------------------------

_INERT_PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10]]


def _inert(side, armed):
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=4,
                     faults=_injector(side, seed=0) if armed else None)
    for p in _INERT_PROMPTS:
        engine.submit(p, max_new=6)
    engine.run_to_completion()
    return engine


@pytest.mark.parametrize("armed", [False, True])
def test_zero_rate_injector_is_bit_identical(armed):
    engine = _inert("port", armed)
    assert [engine.finished[r].out for r in range(3)] == \
        _refs(_INERT_PROMPTS, 6)
    assert engine.stats.quarantined == 0
    assert engine.stats.nonfinite_decode_rounds == 0
    _check_identities(engine)
    _same_as_jax(engine, lambda side: _inert(side, armed))


def _drops(side):
    inj = _injector(side, seed=3, drop_rate=0.7)
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=4,
                     faults=inj)
    for i in range(6):
        engine.submit([i + 1, i + 2, i + 3], max_new=5)
    engine.run_to_completion()
    return engine


def test_drop_upload_faults_keep_streams_exact():
    engine = _drops("port")
    assert engine.faults.counts()["drop_upload"] > 0
    assert [engine.finished[r].out for r in range(6)] == \
        _refs([[i + 1, i + 2, i + 3] for i in range(6)], 5)
    assert engine.stats.completed == 6
    _check_identities(engine)
    _same_as_jax(engine, _drops)


# ---------------------------------------------------------------------------
# NaN quarantine: bounded retry, then FAILED
# ---------------------------------------------------------------------------

def _nan_retry(side):
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=4,
                     faults=_injector(side, nan_at=((4, 0),)),
                     max_retries=2, retry_backoff=2)
    for p in ([1, 2, 3, 4], [5, 6, 7]):
        engine.submit(p, max_new=6)
    engine.run_to_completion()
    return engine


def test_nan_quarantine_retries_and_completes():
    engine = _nan_retry("port")
    assert engine.stats.quarantined >= 1
    assert engine.stats.retried >= 1
    assert engine.stats.nonfinite_decode_rounds >= 1
    assert engine.stats.failed == 0
    assert all(engine.finished[r].status == COMPLETED for r in (0, 1))
    assert [engine.finished[r].out for r in (0, 1)] == \
        _refs([[1, 2, 3, 4], [5, 6, 7]], 6)
    _check_identities(engine)
    _same_as_jax(engine, _nan_retry)


def _exhaust(side):
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=2,
                     faults=_injector(side, seed=1, nan_rate=1.0),
                     max_retries=1, retry_backoff=1)
    for _ in range(2):
        engine.submit([1, 2, 3], max_new=6)
    engine.run_to_completion(max_steps=200)
    return engine


def test_retry_exhaustion_fails_and_drains():
    engine = _exhaust("port")
    assert all(engine.finished[r].status == FAILED for r in (0, 1))
    assert engine.stats.failed == 2
    assert engine.stats.retried == 2
    assert engine.stats.quarantined >= 4
    _check_identities(engine)
    _same_as_jax(engine, _exhaust)


# ---------------------------------------------------------------------------
# Cancellation across the lifecycle
# ---------------------------------------------------------------------------

def _cancels(side):
    engine = _engine(side, max_batch=1, max_len=MAX_LEN, decode_block=4)
    r0 = engine.submit([1, 2], max_new=10)
    r1 = engine.submit([3, 4], max_new=10)
    r2 = engine.submit([5, 6], max_new=10)
    engine.step()
    engine.step()
    assert engine.current[0] is engine.requests[r0]
    assert engine.staged[0] is engine.requests[r1]
    assert engine.cancel(r2)                  # queued
    assert engine.cancel(r1)                  # staged
    assert engine.cancel(r0)                  # in flight: keeps partial
    assert not engine.cancel(r0)
    assert not engine.cancel(12345)
    engine.run_to_completion()
    return engine


def test_cancel_queued_staged_and_inflight():
    engine = _cancels("port")
    outs = {r: engine.finished[r].out for r in (0, 1, 2)}
    assert all(engine.finished[r].status == CANCELLED for r in (0, 1, 2))
    assert outs[1] == outs[2] == []
    ref = _refs([[1, 2]], 10)[0]
    assert 0 < len(outs[0]) < 10 and outs[0] == ref[:len(outs[0])]
    assert engine.stats.cancelled == 3
    _check_identities(engine)
    _same_as_jax(engine, _cancels)


# ---------------------------------------------------------------------------
# Deadlines: sweep for queued / staged / in-flight, shed at admission
# ---------------------------------------------------------------------------

def _deadline_inflight(side):
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=4)
    victim = engine.submit([1, 2, 3], max_new=12)
    engine.submit([4, 5, 6], max_new=12)
    engine.step()
    engine.requests[victim].deadline = engine.stats.decode_steps
    engine.run_to_completion()
    return engine


def test_deadline_sweep_times_out_inflight_with_partial_output():
    engine = _deadline_inflight("port")
    assert engine.finished[0].status == TIMED_OUT
    assert 0 < len(engine.finished[0].out) < 12
    assert engine.finished[1].status == COMPLETED
    assert len(engine.finished[1].out) == 12
    assert engine.stats.timed_out == 1
    _check_identities(engine)
    _same_as_jax(engine, _deadline_inflight)


def _deadline_queued(side):
    engine = _engine(side, max_batch=1, max_len=MAX_LEN, decode_block=4)
    for i in range(3):
        engine.submit([2 * i + 1, 2 * i + 2], max_new=16)
    engine.step()
    engine.requests[1].deadline = engine.stats.decode_steps
    engine.requests[2].deadline = engine.stats.decode_steps
    engine.run_to_completion()
    return engine


def test_deadline_sweep_times_out_queued_and_staged():
    engine = _deadline_queued("port")
    assert engine.finished[1].status == TIMED_OUT
    assert engine.finished[2].status == TIMED_OUT
    assert engine.finished[1].out == [] and engine.finished[2].out == []
    assert engine.finished[0].status == COMPLETED
    _check_identities(engine)
    _same_as_jax(engine, _deadline_queued)


def _shed(side):
    engine = _engine(side, max_batch=1, max_len=MAX_LEN, decode_block=4)
    engine.submit([1, 2], max_new=20)
    engine.submit([3, 4], max_new=20, deadline=4)
    engine.submit([5, 6], max_new=4, deadline=512)
    engine.run_to_completion()
    return engine


def test_unmeetable_deadline_shed_at_admission():
    engine = _shed("port")
    assert engine.requests[1].verdict == SHED_UNMEETABLE_DEADLINE
    assert engine.requests[1].status == SHED
    assert engine.finished[1].out == []
    assert engine.stats.shed == 1
    assert engine.requests[2].verdict == ADMITTED
    assert engine.finished[0].status == COMPLETED
    assert engine.finished[2].status == COMPLETED
    assert len(engine.finished[2].out) == 4
    _check_identities(engine)
    _same_as_jax(engine, _shed)


# ---------------------------------------------------------------------------
# Bounded queue: backpressure sheds instead of growing
# ---------------------------------------------------------------------------

def _bounded(side):
    engine = _engine(side, max_batch=1, max_len=MAX_LEN, decode_block=4,
                     max_queue=2, low_watermark=0.5)
    rids = [engine.submit([i + 1, i + 2], max_new=4) for i in range(8)]
    rejected = [r for r in rids
                if engine.requests[r].verdict == REJECTED_QUEUE_FULL]
    assert rejected
    assert engine.stats.queue_peak <= 2
    engine.run_to_completion()
    late = engine.submit([9, 9], max_new=4)
    assert engine.requests[late].verdict == ADMITTED
    engine.run_to_completion()
    return engine


def test_bounded_queue_rejects_burst_and_recovers():
    engine = _bounded("port")
    rejected = [r for r in range(8)
                if engine.requests[r].verdict == REJECTED_QUEUE_FULL]
    assert all(engine.requests[r].status == SHED for r in rejected)
    assert engine.stats.rejected == len(rejected)
    assert all(engine.finished[r].status == COMPLETED
               for r in range(9) if r not in rejected)
    _check_identities(engine)
    _same_as_jax(engine, _bounded)


# ---------------------------------------------------------------------------
# Submit-time validation + stall diagnosis
# ---------------------------------------------------------------------------

def test_submit_validates_controls_and_budget():
    engine = _engine("port", max_batch=1, max_len=16)
    for args, kw in ((([],), dict(max_new=4)),
                     (([1, 2],), dict(max_new=64)),
                     (([1],), dict(max_new=4, temperature=-0.5)),
                     (([1],), dict(max_new=4, top_k=-1)),
                     (([1],), dict(max_new=4, top_p=0.0)),
                     (([1],), dict(max_new=4, top_p=1.5)),
                     (([1],), dict(max_new=4, deadline=0))):
        with pytest.raises(ValueError):
            engine.submit(*args, **kw)
    _, pcfg, _, pparams = _pair()
    with pytest.raises(ValueError):
        pt_engine.generate_one(pcfg, pparams, [], max_new=4, max_len=16,
                               device="cpu")
    assert engine.stats.submitted == 0


def _stall(side):
    engine = _engine(side, max_batch=1, max_len=MAX_LEN, decode_block=1)
    engine.submit([1, 2, 3], max_new=20)
    engine.submit([4, 5, 6], max_new=20)
    with pytest.raises(EngineStallError if side == "port"
                       else jax_engine.EngineStallError) as ei:
        engine.run_to_completion(max_steps=2)
    return engine, ei.value


def test_run_to_completion_stall_raises_with_occupancy_report():
    engine, err = _stall("port")
    rep = err.report
    assert rep["in_flight"] == 1 and rep["staged"] == 1
    assert rep["slots"][0]["current"]["rid"] == 0
    assert rep["decode_steps"] == 2
    # the report and the message are the reference's, field for field
    jeng, jerr = _stall("jax")
    assert rep == jerr.report
    assert str(err) == str(jerr)
    assert engine.occupancy_report() == jeng.occupancy_report()
    engine.run_to_completion()
    assert engine.stats.completed == 2


def _total_outage(side):
    """One data shard (no mesh) crashed at round 2: every row dies, the
    staged and in-flight requests go back to the queue, and nothing can
    serve them."""
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=2,
                     faults=_injector(side, shard_crash_at=((2, 0),)),
                     mesh=None)
    for i in range(3):
        engine.submit([i + 1, i + 2, i + 3], max_new=6)
    with pytest.raises(EngineStallError if side == "port"
                       else jax_engine.EngineStallError) as ei:
        engine.run_to_completion(max_steps=6)
    return engine, ei.value


def test_shard_crash_without_mesh_requeues_and_stalls_as_reference():
    engine, err = _total_outage("port")
    assert engine.dead_shards == {0}
    assert engine.stats.shard_crashes == 1
    assert engine.stats.failover_requeued == 2   # the two rows' requests
    assert engine.stats.retried == 0
    assert err.report["dead_shards"] == [0]
    assert err.report["queue_depth"] == 3
    jeng, jerr = _total_outage("jax")
    assert err.report == jerr.report and str(err) == str(jerr)
    assert _outcome(engine) == _outcome(jeng)
    assert engine.stats.failover_requeued == jeng.stats.failover_requeued


# ---------------------------------------------------------------------------
# Speculative degradation: rolling accept-rate floor
# ---------------------------------------------------------------------------

def _spec_floor(side):
    engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=2,
                     speculative="ngram", draft_len=4,
                     spec_accept_floor=1.01, spec_window=1)
    for p in ([1, 2, 3, 4], [5, 6, 7]):
        engine.submit(p, max_new=10)
    engine.run_to_completion()
    return engine


def test_spec_accept_floor_disables_drafting_keeps_streams():
    engine = _spec_floor("port")
    assert engine.stats.spec_disabled >= 1
    assert not engine._spec_active
    assert [engine.finished[r].out for r in (0, 1)] == \
        _refs([[1, 2, 3, 4], [5, 6, 7]], 10)
    _check_identities(engine)
    jeng = _spec_floor("jax")
    assert _outcome(engine) == _outcome(jeng)
    assert engine.stats.spec_disabled == jeng.stats.spec_disabled


# ---------------------------------------------------------------------------
# Chaos replay: mixed trace under all fault kinds at once
# ---------------------------------------------------------------------------

def _chaos(side):
    rng = np.random.default_rng(7)
    inj = _injector(side, seed=5, nan_rate=0.01, drop_rate=0.1,
                    straggler_rate=0.1, straggler_s=0.001)
    engine = _engine(side, max_batch=4, max_len=MAX_LEN, decode_block=4,
                     faults=inj, max_retries=2, retry_backoff=2,
                     max_queue=8)
    for i in range(24):
        prompt = list(rng.integers(1, 250, size=int(rng.integers(2, 9))))
        kw = {}
        if i % 4 == 0:
            kw["deadline"] = 2 * (len(prompt) + 12)
        engine.submit(prompt, max_new=int(rng.integers(4, 13)),
                      priority=int(rng.integers(0, 3)), **kw)
        if i % 3 == 2:
            engine.step()
    engine.run_to_completion(max_steps=2000)
    return engine


@pytest.mark.slow
def test_chaos_trace_every_request_terminal():
    engine = _chaos("port")
    assert sum(v > 0 for v in engine.faults.counts().values()) >= 2
    assert len(engine.finished) == 24
    assert all(r.status in TERMINAL_STATUSES
               for r in engine.finished.values())
    assert engine.stats.completed > 0
    _check_identities(engine)
    _same_as_jax(engine, _chaos)


def test_occupancy_report_matches_reference_under_faults():
    """Mid-run, with a NaN retry in backoff and a deadline set, the
    report carries the reference's fields and values."""
    def run(side):
        engine = _engine(side, max_batch=2, max_len=MAX_LEN, decode_block=2,
                         faults=_injector(side, nan_at=((2, 1),)),
                         max_retries=2, retry_backoff=4)
        engine.submit([1, 2, 3], max_new=8, deadline=40)
        engine.submit([4, 5, 6, 7], max_new=8)
        engine.submit([8, 9], max_new=8)
        for _ in range(3):
            engine.step()
        return engine

    port, ref = run("port"), run("jax")
    rep = port.occupancy_report()
    assert rep == ref.occupancy_report()
    assert {"deadline", "retries"} <= set(rep["slots"][0]["current"])
    assert "dead_shards" in rep
    assert port.stats.retried == 1
