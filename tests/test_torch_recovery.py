"""Port parity for crash-tolerant serving: ``serving/recovery.py``,
``ServingEngine.restore`` and ``replay_trace`` (the port of
``tests/test_recovery.py``; its two meshed cases run on a 2x1 world of
CPU ranks, ``tests/torch_mesh_ranks.py``, beside a meshed kill /
restore).

Greedy and seeded-sampled streams are a pure function of the submit /
cancel / step sequence, so an engine rebuilt from the newest good
snapshot plus journal-tail replay must finish every request with streams
and round clock bit-identical to an uninterrupted run.  On top of the
reference's cases: the port's journal data records equal the JAX
engine's byte for byte (seq and CRC included) for a trace with faults and
cancels, a speculative engine restores bit-identically, restored state
leaves sit where a fresh engine puts them, and a journal written for
another device does not restore.  The port runs on CPU tensors.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.serving import faults as jax_faults
from repro.serving import recovery as jax_recovery
from repro_torch import bridge
from repro_torch.configs import archs
from repro_torch.distributed import serve_mesh
from repro_torch.serving import recovery
from repro_torch.serving.engine import (
    CANCELLED, ServingEngine, replay_trace)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.recovery import Journal, RecoveryError
from repro_torch.training import checkpoint as ckpt

import torch_mesh_ranks as ranks

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_archs.smoke("mingru-lm")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, archs.smoke("mingru-lm"), jparams, pparams


def _setup():
    _, cfg, _, params = _pair()
    return cfg, params


def _engine(recover_dir=None, **kw):
    cfg, params = _setup()
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("decode_block", 1)
    return ServingEngine(cfg, params, recover_dir=recover_dir,
                         device="cpu", **kw)


def _restore(path, **kw):
    cfg, params = _setup()
    return ServingEngine.restore(path, cfg, params, device="cpu", **kw)


def _trace(n, seed=0):
    rng = np.random.default_rng(seed)
    t = [dict(arrival=int(rng.integers(0, 3 * n)),
              prompt=[int(x) for x in
                      rng.integers(1, 250, size=int(rng.integers(2, 6)))],
              max_new=int(rng.integers(3, 8)))
         for _ in range(n)]
    t.sort(key=lambda r: r["arrival"])
    return t


def _submitter(eng):
    # mixed greedy / sampled requests: BOTH must replay bit-identically
    def fn(i, r):
        eng.submit(r["prompt"], max_new=r["max_new"],
                   temperature=0.0 if i % 2 == 0 else 0.8,
                   top_k=0 if i % 2 == 0 else 40)
    return fn


def _outs(eng):
    return {rid: req.out for rid, req in sorted(eng.finished.items())}


def _jpath(tmp_path):
    return os.path.join(str(tmp_path), recovery.JOURNAL_NAME)


# ---------------------------------------------------------------------------
# Journal codec (pure host logic, no model)
# ---------------------------------------------------------------------------

def _mk_journal(tmp_path):
    j = Journal.create(_jpath(tmp_path),
                       {"config": {"name": "t"}, "engine": {}})
    j.record_submit({"rid": 0, "round": 0, "prompt": [1, 2], "max_new": 4})
    j.record_step({"round": 0, "k": 4, "emits": [[0, 7]],
                   "digest": {"completed": 0}})
    j.record_cancel({"rid": 0, "round": 4})
    j.close()
    return _jpath(tmp_path)


def test_journal_roundtrip(tmp_path):
    path = _mk_journal(tmp_path)
    header, records, dropped, good = recovery.read_journal(path)
    assert header is not None and header["config"] == {"name": "t"}
    assert [r["kind"] for r in records] == ["submit", "step", "cancel"]
    assert [r["seq"] for r in records] == [1, 2, 3]
    assert dropped == 0 and good == os.path.getsize(path)
    # the reference reads the port's file to the same records
    assert jax_recovery.read_journal(path) == (header, records, dropped,
                                               good)


def test_journal_numpy_scalars_normalized(tmp_path):
    j = Journal.create(_jpath(tmp_path), {"config": {}, "engine": {}})
    j.record_submit({"rid": 0, "prompt": list(np.arange(3)),
                     "max_new": np.int64(4)})
    j.close()
    _, records, dropped, _ = recovery.read_journal(_jpath(tmp_path))
    assert dropped == 0
    assert records[0]["prompt"] == [0, 1, 2]
    assert records[0]["max_new"] == 4


def test_journal_torn_tail_dropped_then_truncated_on_resume(tmp_path):
    path = _mk_journal(tmp_path)
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b'{"seq":4,"kind":"step","torn')        # no newline
    header, records, dropped, good = recovery.read_journal(path)
    assert header is not None
    assert len(records) == 3 and dropped == 1
    assert good == good_size
    j = Journal.for_replay(path, list(records),
                           records[-1]["seq"] + 1, good)
    j.record_submit({"rid": 0, "round": 0, "prompt": [1, 2], "max_new": 4})
    j.record_step({"round": 0, "k": 4, "emits": [[0, 7]],
                   "digest": {"completed": 0}})
    assert j.replaying
    j.record_cancel({"rid": 0, "round": 4})
    assert not j.replaying
    assert j.replayed == 3 and j.replayed_rounds == 4
    assert os.path.getsize(path) == good_size
    j.record_step({"round": 4, "k": 4, "emits": [], "digest": {}})
    j.close()
    _, records2, dropped2, _ = recovery.read_journal(path)
    assert dropped2 == 0
    assert [r["seq"] for r in records2] == [1, 2, 3, 4]


def test_journal_mid_corruption_stops_reading(tmp_path):
    path = _mk_journal(tmp_path)
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    lines[2] = lines[2].replace(b'"step"', b'"stop"', 1)  # breaks the crc
    with open(path, "wb") as f:
        f.writelines(lines)
    header, records, dropped, good = recovery.read_journal(path)
    assert header is not None
    assert [r["kind"] for r in records] == ["submit"]
    assert dropped == 2
    assert good == len(lines[0]) + len(lines[1])


def test_journal_replay_divergence_raises(tmp_path):
    path = _mk_journal(tmp_path)
    _, records, _, good = recovery.read_journal(path)
    j = Journal.for_replay(path, list(records), 4, good)
    with pytest.raises(RecoveryError, match="divergence"):
        j.record_step({"round": 0, "k": 4})
    j = Journal.for_replay(path, list(records), 4, good)
    with pytest.raises(RecoveryError, match="rid"):
        j.record_submit({"rid": 5, "round": 0, "prompt": [1, 2],
                         "max_new": 4})


# ---------------------------------------------------------------------------
# Journaling is inert, and its data records are the reference's
# ---------------------------------------------------------------------------

def test_journaling_is_inert(tmp_path):
    trace = _trace(5, seed=1)
    ref = _engine()
    replay_trace(ref, trace, _submitter(ref))
    eng = _engine(recover_dir=str(tmp_path), snapshot_every=3)
    replay_trace(eng, trace, _submitter(eng))
    assert _outs(eng) == _outs(ref)
    assert eng.stats.decode_steps == ref.stats.decode_steps
    header, records, dropped, _ = recovery.read_journal(_jpath(tmp_path))
    assert dropped == 0
    assert header["engine"]["max_batch"] == 2
    assert header["config"]["device"] == "cpu"
    assert sum(r["kind"] == "submit" for r in records) == len(trace)
    assert recovery.list_snapshots(str(tmp_path))


def _faulty_drive(eng, trace):
    """A mixed trace with NaN and dropped-upload faults and two
    cancels (one of a queued or staged request, one of a finished one)."""
    def stop(e):
        if e.stats.decode_steps == 6:
            e.cancel(5)
            e.cancel(0)
        return False
    replay_trace(eng, trace, _submitter(eng), stop=stop)


def test_journal_data_records_equal_the_reference(tmp_path):
    trace = _trace(8, seed=5)
    fkw = dict(seed=2, nan_rate=0.02, drop_rate=0.3)
    eng = _engine(recover_dir=str(tmp_path / "port"), snapshot_every=4,
                  decode_block=2, faults=FaultInjector(**fkw))
    _faulty_drive(eng, trace)
    eng.journal.close()
    jcfg, _, jparams, _ = _pair()
    jeng = jax_engine.ServingEngine(
        jcfg, jparams, max_batch=2, max_len=MAX_LEN, decode_block=2,
        faults=jax_faults.FaultInjector(**fkw),
        recover_dir=str(tmp_path / "jax"), snapshot_every=4)
    _faulty_drive(jeng, trace)
    jeng.journal.close()
    assert eng.faults.events == jeng.faults.events
    assert sum(n > 0 for n in eng.faults.counts().values()) == 2
    with open(tmp_path / "port" / recovery.JOURNAL_NAME, "rb") as f:
        port_lines = f.read().splitlines()
    with open(tmp_path / "jax" / recovery.JOURNAL_NAME, "rb") as f:
        jax_lines = f.read().splitlines()
    assert any(b'"kind":"cancel"' in ln for ln in port_lines)
    # the header differs (the port's stamp names its device, its knobs
    # have no block_dh); every data record is the same bytes
    assert port_lines[1:] == jax_lines[1:]
    assert len(port_lines) > 20


# ---------------------------------------------------------------------------
# Kill / restore: the bit-exactness contract
# ---------------------------------------------------------------------------

def _kill_and_restore(tmp_path, trace, kill_round, snapshot_every, **kw):
    """Run a journaled engine until ``kill_round``, abandon it (the
    "crash"), restore on fresh objects and finish the trace."""
    eng = _engine(recover_dir=str(tmp_path), snapshot_every=snapshot_every,
                  **kw)
    replay_trace(eng, trace, _submitter(eng),
                 stop=lambda e: e.stats.decode_steps >= kill_round)
    assert len(eng.finished) < len(trace)
    eng.journal.close()
    del eng
    rec = _restore(str(tmp_path))
    replay_trace(rec, trace, _submitter(rec), start=len(rec.requests))
    return rec


def test_kill_restore_bit_identical(tmp_path):
    trace = _trace(6, seed=2)
    ref = _engine()
    replay_trace(ref, trace, _submitter(ref))
    rec = _kill_and_restore(tmp_path, trace, kill_round=7,
                            snapshot_every=3)
    rep = rec.recovery_report
    assert rep["snapshot_round"] is not None
    assert rep["replayed_records"] >= 1
    assert rep["replayed_rounds"] >= 1
    assert rep["dropped_tail_records"] == 0
    assert rep["recovery_s"] >= rep["replay_s"] >= 0.0
    assert _outs(rec) == _outs(ref)
    assert rec.stats.decode_steps == ref.stats.decode_steps
    assert rec.stats.completed == len(trace)
    _, records, dropped, _ = recovery.read_journal(_jpath(tmp_path))
    assert dropped == 0
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))


def test_cold_restore_replays_journal_from_scratch(tmp_path):
    trace = _trace(4, seed=3)
    ref = _engine()
    replay_trace(ref, trace, _submitter(ref))
    rec = _kill_and_restore(tmp_path, trace, kill_round=5,
                            snapshot_every=10 ** 9)
    rep = rec.recovery_report
    assert rep["snapshot"] is None and rep["snapshot_round"] is None
    assert rep["replayed_records"] == rep["journal_records"]
    assert _outs(rec) == _outs(ref)
    assert rec.stats.decode_steps == ref.stats.decode_steps


def test_corrupt_snapshot_falls_back_a_generation(tmp_path):
    trace = _trace(6, seed=4)
    ref = _engine()
    replay_trace(ref, trace, _submitter(ref))
    eng = _engine(recover_dir=str(tmp_path), snapshot_every=2)
    replay_trace(eng, trace, _submitter(eng),
                 stop=lambda e: e.stats.decode_steps >= 9)
    eng.journal.close()
    del eng
    rounds = recovery.list_snapshots(str(tmp_path))
    assert len(rounds) >= 2
    newest = recovery.snapshot_path(str(tmp_path), rounds[-1])
    with open(os.path.join(newest, "arrays.npz"), "ab") as f:
        f.write(b"bitrot")
    rec = _restore(str(tmp_path))
    rep = rec.recovery_report
    assert rep["corrupt_snapshots_skipped"] == [rounds[-1]]
    assert rep["snapshot_round"] == rounds[-2]
    replay_trace(rec, trace, _submitter(rec), start=len(rec.requests))
    assert _outs(rec) == _outs(ref)


def test_cancel_survives_kill_and_replay(tmp_path):
    def ops(eng):
        rids = [eng.submit([i + 1, i + 2, i + 3], max_new=8)
                for i in range(3)]
        eng.step()
        eng.step()
        eng.cancel(rids[1])
        return rids

    ref = _engine(max_batch=1)
    rids = ops(ref)
    ref.run_to_completion()

    eng = _engine(recover_dir=str(tmp_path), snapshot_every=4,
                  max_batch=1)
    assert ops(eng) == rids
    for _ in range(3):
        eng.step()
    eng.journal.close()
    del eng
    rec = _restore(str(tmp_path))
    rec.run_to_completion()
    assert _outs(rec) == _outs(ref)
    assert rec.finished[rids[1]].status == CANCELLED
    assert rec.stats.cancelled == 1
    assert rec.stats.completed == 2


def test_restore_config_mismatch_raises(tmp_path):
    _, params = _setup()
    eng = _engine(recover_dir=str(tmp_path))
    eng.submit([1, 2, 3], max_new=3)
    eng.step()
    eng.journal.close()
    with pytest.raises(RecoveryError, match="config"):
        ServingEngine.restore(str(tmp_path), archs.smoke("minlstm-lm"),
                              params, device="cpu")


def test_restore_device_mismatch_raises(tmp_path):
    """A journal stamped for the card does not restore on the CPU (the
    kernels and the plain versions round differently)."""
    eng = _engine(recover_dir=str(tmp_path))
    eng.submit([1, 2, 3], max_new=3)
    eng.step()
    eng.journal.close()
    with open(_jpath(tmp_path), "rb") as f:
        lines = f.read().splitlines(keepends=True)
    head = json.loads(lines[0])
    head["config"]["device"] = "NVIDIA H100 80GB HBM3"
    head["crc"] = recovery._crc(head)
    lines[0] = (json.dumps(head, sort_keys=True, separators=(",", ":"))
                + "\n").encode()
    with open(_jpath(tmp_path), "wb") as f:
        f.writelines(lines)
    with pytest.raises(RecoveryError, match="device"):
        _restore(str(tmp_path))


def test_restore_without_journal_raises(tmp_path):
    with pytest.raises(RecoveryError, match="journal"):
        _restore(str(tmp_path))


def test_apply_snapshot_rejects_knob_mismatch(tmp_path):
    eng = _engine()
    eng.submit([1, 2, 3], max_new=4)
    eng.step()
    arrays, manifest = recovery.snapshot_engine(eng)
    manifest = json.loads(json.dumps(manifest, default=recovery._np_item))
    clone = _engine(decode_block=2)
    with pytest.raises(RecoveryError, match="decode_block"):
        recovery.apply_snapshot(clone, arrays, manifest)


def _roundtrip(eng, directory, **kw):
    """Snapshot ``eng`` to disk and apply it onto a fresh engine of the
    same knobs."""
    path = recovery.save_snapshot(eng, str(directory))
    arrays, manifest = recovery.load_snapshot(path)
    clone = _engine(**kw)
    recovery.apply_snapshot(clone, arrays, manifest)
    return clone


def test_restored_leaves_sit_where_a_fresh_engine_puts_them(tmp_path):
    eng = _engine(speculative="ngram", draft_len=4)
    eng.submit([1, 2, 3], max_new=6, temperature=0.8, top_k=40)
    eng.submit([4, 5], max_new=6)
    for _ in range(3):
        eng.step()
    clone = _roundtrip(eng, tmp_path, speculative="ngram", draft_len=4)
    fresh = ckpt.flatten_tree(_engine(speculative="ngram",
                                      draft_len=4).state, "state")
    got = ckpt.flatten_tree(clone.state, "state")
    assert set(got) == set(fresh)
    for k, leaf in got.items():
        assert leaf.dtype == fresh[k].dtype, k
        assert leaf.device == fresh[k].device == clone.device or \
            k.endswith("|keys"), k
    assert got["state|keys"].device.type == "cpu"
    # snapshotted as they stand: the lagging key chain is not caught up
    assert (got["state|keys"] == eng.state["keys"]).all()
    assert (got["state|key_lag"] == eng.state["key_lag"]).all()
    assert eng.run_to_completion() == clone.run_to_completion()


@pytest.mark.parametrize("kill_round", [3, 8])
def test_speculative_kill_restore_bit_identical(tmp_path, kill_round):
    """n-gram S 4 at C 4: the snapshot carries ``n_out``, the source's
    state and the accept-floor state, so the restored engine makes the
    same accept / disable decisions."""
    trace = [dict(arrival=i, prompt=[3, 4, 5, 3, 4, 5, 3, 4][:4 + i % 4],
                  max_new=10) for i in range(5)]
    kw = dict(decode_block=2, prompt_chunk=4, speculative="ngram",
              draft_len=4, spec_accept_floor=0.9, spec_window=2,
              spec_cooldown=2)
    ref = _engine(**kw)
    replay_trace(ref, trace, _submitter(ref))
    rec = _kill_and_restore(tmp_path, trace, kill_round=kill_round,
                            snapshot_every=2, **kw)
    assert rec.recovery_report["snapshot_round"] is not None
    assert _outs(rec) == _outs(ref)
    assert rec.stats.decode_steps == ref.stats.decode_steps
    assert rec.stats.draft_accepted == ref.stats.draft_accepted > 0
    assert rec.stats.spec_disabled == ref.stats.spec_disabled


# ---------------------------------------------------------------------------
# Property: snapshot -> apply resumes bit-identically from ANY state
# ---------------------------------------------------------------------------

@pytest.mark.slow
@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 4),
       rounds=st.integers(0, 9))
def test_snapshot_roundtrip_resumes_bit_identically(seed, n, rounds):
    eng = _engine()
    rng = np.random.default_rng(seed)
    for i in range(n):
        eng.submit([int(x) for x in
                    rng.integers(1, 250, size=int(rng.integers(1, 5)))],
                   max_new=int(rng.integers(2, 7)),
                   temperature=0.0 if i % 2 == 0 else 0.7,
                   top_k=0 if i % 2 == 0 else 20)
        if i % 2 == 1:
            eng.step()
    for _ in range(rounds):
        eng.step()
    arrays, manifest = recovery.snapshot_engine(eng)
    manifest = json.loads(json.dumps(manifest, default=recovery._np_item))
    clone = _engine()
    recovery.apply_snapshot(clone, arrays, manifest)
    assert eng.run_to_completion() == clone.run_to_completion()
    assert clone.stats.decode_steps == eng.stats.decode_steps


# ---------------------------------------------------------------------------
# DP-shard failover and meshed snapshots (a 2x1 world of CPU ranks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """Every rank's results of ``torch_mesh_ranks.recovery_world``."""
    return serve_mesh.run_world(ranks.recovery_world, 2, (
        _setup()[1], str(tmp_path_factory.mktemp("mesh"))))


def test_shard_crash_failover_completes_on_survivors(mesh_world):
    """Shard 1 dies at round 4: its requests finish on shard 0 with the
    uninterrupted streams, the identities hold with the dead rows idling
    as waste, and the run equals the JAX engine's meshed failover."""
    for r in mesh_world:
        f = r["failover"]
        assert f["rids_equal"]
        assert f["crash_count"] == 1 and f["shard_crashes"] == 1
        assert f["dead_shards"] == [1] == f["report_dead"]
        assert f["failover_requeued"] >= 1
        assert f["retried"] == 0     # an infrastructure fault burns none
        assert all(s == "COMPLETED" for s in f["statuses"])
        assert f["streams"] == f["ref_streams"]
        assert f["completed"] == f["submitted"] == 6
        assert f["identities_ok"]
        assert f["rounds"] > f["ref_rounds"]    # half the pool survives
    jcfg, _, jparams, _ = _pair()
    jeng = jax_engine.ServingEngine(
        jcfg, jparams, max_batch=4, max_len=MAX_LEN, decode_block=2,
        mesh="2x1", faults=jax_faults.FaultInjector(shard_crash_at=((4, 1),)))
    rids = [jeng.submit([i + 1, i + 2, i + 3], max_new=5) for i in range(6)]
    jout = jeng.run_to_completion()
    f = mesh_world[0]["failover"]
    assert f["streams"] == [jout[r] for r in rids]
    assert f["rounds"] == jeng.stats.decode_steps


def test_meshed_snapshot_roundtrip_preserves_dead_shards(mesh_world):
    """A 2x1 engine's snapshot holds the global state (shard 1 dead at
    round 2); a fresh 2x1 engine applies it, each rank keeping its cut,
    and both finish alike."""
    cfg = _setup()[0]
    for r in mesh_world:
        t = r["roundtrip"]
        assert t["dead_before"] == [1] == t["clone_dead"]
        assert t["clone_crashed"] == [1]
        assert t["h_shape"] == (cfg.n_layers, 4, 2 * cfg.d_model)
        assert t["orig"] == t["clone"]
        assert t["rounds"][0] == t["rounds"][1]


def test_meshed_kill_restore_matches_uninterrupted(mesh_world):
    """A journaled 2x1 run abandoned after 5 steps restores on both ranks
    (rank 0 alone wrote the journal and snapshots) and finishes with the
    streams and round clock of an uninterrupted 2x1 run, greedy and
    seeded-sampled requests alike."""
    writers = [r["restore"]["writer"] for r in mesh_world]
    assert writers == [True, False]
    for r in mesh_world:
        rs = r["restore"]
        assert rs["journal_exists"]
        assert rs["report"]["snapshot_round"] == 8
        assert rs["report"]["replayed_records"] >= 1
        assert rs["restored"] == rs["full"]
        assert rs["rounds"][0] == rs["rounds"][1]
