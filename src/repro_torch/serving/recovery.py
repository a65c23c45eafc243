"""Crash-tolerant serving: engine snapshots + a write-ahead request
journal with deterministic replay recovery.

The port of ``repro.serving.recovery``, with the same formats
(``JOURNAL_FORMAT`` / ``SNAPSHOT_FORMAT``, versions, file names) and a
journal whose data records equal the reference's byte for byte: the same
payload keys, the same stats digest and the same CRC rule.

The paper's O(1) recurrent state (Were RNNs All We Needed?, section 4.1)
is what makes *full engine* checkpointing cheap enough to do between
supersteps: a serving snapshot is the O(B x d_hidden) slot pool -- h and
conv rows, positions, sampling key chains -- plus host-side request
bookkeeping, not a paged KV tree whose size grows with every token in
flight.

Two cooperating pieces, layered on the engine's determinism contract
(greedy and seeded streams are a pure function of the submit / cancel /
step sequence -- wall clock feeds stats only, never control flow):

  * **Snapshots** -- a versioned, config-stamped codec
    (:func:`snapshot_engine` / :func:`apply_snapshot`) serializing the
    full serving state: every slot-state leaf (flattened with
    ``training/checkpoint.py``'s path-key scheme; bf16 as its bit
    pattern), the numpy staging mirrors, scheduler queue order and
    backoff / deadline fields, request lifecycle and partial outputs,
    ``EngineStats``, the speculative-degradation state and the chaos
    injector's RNG states.  Written atomically to
    ``<dir>/snap_<round>/arrays.npz + manifest.json`` with a sha256
    content checksum; restore walks generations newest first and falls
    back past corrupt ones.  The slot state mixes containers: the
    per-slot key chains ``keys`` live on the host (int64 holding uint32
    values), every other leaf on the engine's device.  Each leaf goes
    back where, and in the dtype that, a fresh ``init_slot_state`` puts
    it, and ``keys`` / ``key_lag`` are stored as they stand (the chain is
    caught up lazily; a caught-up copy would offset the restored chain).
    The kernels' bound weights (``ServingEngine.layers``, a
    ``ModelDraft``'s binding) are made by the constructor from the
    params and are never part of a snapshot.
  * **Write-ahead journal** -- an append-only JSONL (:class:`Journal`)
    of every engine mutation: ``submit`` records are fsync'd *before*
    the engine mutates (the rid is deterministic, so the record can
    promise it), ``cancel`` likewise, and each ``step`` appends its
    emissions and a stats digest after the superstep drains, fsync'd
    once per host round-trip.  Each record carries a seq number and a
    CRC; a torn tail line is dropped (and truncated before new appends),
    a mid-file corruption stops replay at the last good record.

``restore_engine`` (surfaced as ``ServingEngine.restore``) rebuilds the
engine from the journal header's constructor knobs, loads the newest
good snapshot, then *re-executes* the journal tail through the real
``submit`` / ``cancel`` / ``step`` code paths, verifying each
re-executed operation against its record, and flips to append mode when
the tail is exhausted.

**Device.** The config stamp carries the device (``tuning.config_stamp``):
a journal or snapshot written on the card restores only on a card of the
same name, one written on the CPU only on the CPU, and a mismatch raises
:class:`RecoveryError` naming the field.  The kernels and their plain
versions round differently, so a replay on the other device would
diverge at its first step digest anyway.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import serve_mesh
from repro_torch.serving import tuning
from repro_torch.serving.faults import FaultConfig, FaultInjector
from repro_torch.serving.scheduler import EngineStats, ShardStats
from repro_torch.training import checkpoint as ckpt

JOURNAL_NAME = "journal.jsonl"
JOURNAL_FORMAT = "serving-journal"
JOURNAL_VERSION = 1
SNAPSHOT_FORMAT = "serving-snapshot"
SNAPSHOT_VERSION = 1
_SNAP_PREFIX = "snap_"
_SMIRROR = "smirror"


class RecoveryError(RuntimeError):
    """Recovery cannot proceed (config mismatch, missing/corrupt
    journal, or a replayed operation diverging from its record)."""


class SnapshotCorruptError(RecoveryError):
    """A snapshot generation failed its sha256 / manifest check."""


def _np_item(obj):
    """json.dumps default hook: numpy scalars -> python scalars (prompt
    tokens often arrive as np.int64 from traces)."""
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    raise TypeError(f"not JSON-serializable: {obj!r}")


def _jnorm(obj):
    """JSON round-trip normalization: tuples -> lists, numpy scalars ->
    python scalars, so recorded and live values compare equal."""
    return json.loads(json.dumps(obj, default=_np_item))


def config_stamp(cfg, device="cuda") -> dict:
    """The config fields a snapshot/journal is valid for: the tuning
    stamp (name / layers / widths / dtype / device) plus the fields that
    change the slot-state layout or the emitted streams."""
    stamp = tuning.config_stamp(cfg, device)
    stamp["vocab_size"] = cfg.vocab_size
    stamp["block_kind"] = cfg.block_kind
    return stamp


def _check_stamp(what: str, recorded: dict, stamp: dict):
    diff = sorted(k for k in set(recorded) | set(stamp)
                  if recorded.get(k) != stamp.get(k))
    if diff:
        raise RecoveryError(
            f"{what} was written for config {recorded}, engine config is "
            f"{stamp} (differs in " + ", ".join(
                f"{k}: {recorded.get(k)!r} != {stamp.get(k)!r}"
                for k in diff) + ")")


def engine_knobs(engine) -> dict:
    """Constructor knobs needed to rebuild ``engine`` equivalently --
    everything that shapes device state, placement or replay control
    flow.  All values JSON-able; recorded in the journal header and
    every snapshot manifest (they must agree at restore).  The port has
    no ``block_dh`` (the kernels plan their own tiles)."""
    from repro_torch.serving import draft as draft_lib
    draft = engine.draft
    spec_name = ngram = None
    if draft is not None:
        if isinstance(draft, draft_lib.NGramDraft):
            spec_name, ngram = "ngram", draft.ngram
        else:
            spec_name = type(draft).__name__
    sc = engine.scheduler.cfg
    return {
        "max_batch": engine.max_batch, "max_len": engine.max_len,
        "seed": engine.seed,
        "decode_block": engine.decode_block,
        "prompt_chunk": engine.prompt_chunk,
        "speculative": spec_name,
        "draft_len": None if draft is None else draft.draft_len,
        "draft_ngram": ngram,
        "max_queue": sc.max_queue,
        "high_watermark": sc.high_watermark,
        "low_watermark": sc.low_watermark,
        "aging_rounds": sc.aging_rounds,
        "max_retries": engine.max_retries,
        "retry_backoff": engine.retry_backoff,
        "spec_accept_floor": engine.spec_accept_floor,
        "spec_window": engine.spec_window,
        "spec_cooldown": engine.spec_cooldown,
        "mesh": None if engine.mesh_plan is None else str(engine.mesh_plan),
        "fuse_block": engine.cfg.fuse_block,
        "faults": None if engine.faults is None
        else dataclasses.asdict(engine.faults.cfg),
    }


def engine_header(engine) -> dict:
    return {"format": JOURNAL_FORMAT, "version": JOURNAL_VERSION,
            "config": config_stamp(engine.cfg, engine.device),
            "engine": engine_knobs(engine),
            "snapshot": {"every": engine.snapshot_every,
                         "keep": engine.snapshot_keep}}


# ---------------------------------------------------------------------------
# Write-ahead journal
# ---------------------------------------------------------------------------

def _crc(rec: dict) -> int:
    body = {k: v for k, v in rec.items() if k != "crc"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":"),
                   default=_np_item).encode())


def read_journal(path: str):
    """Parse a journal file tolerantly.  Returns ``(header, records,
    dropped, good_bytes)``: the header record (or None), the good data
    records in seq order, how many trailing lines were dropped (torn
    tail or corruption -- reading stops at the first bad line; records
    after a corrupt one cannot be trusted to be gap-free), and the byte
    offset of the end of the last good record (append resumes there)."""
    with open(path, "rb") as f:
        data = f.read()
    header, records = None, []
    good, pos, dropped = 0, 0, 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:        # torn final line (no newline): drop it
            dropped += 1
            break
        line = data[pos:nl]
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or rec.get("crc") != _crc(rec):
                raise ValueError("crc mismatch")
        except (ValueError, TypeError):
            dropped += sum(1 for ln in data[pos:].split(b"\n") if ln)
            break
        if rec.get("kind") == "header":
            header = rec
        else:
            records.append(rec)
        good = nl + 1
        pos = nl + 1
    return header, records, dropped, good


class Journal:
    """Append-only, CRC'd, seq-numbered record log of engine mutations.

    Two modes.  **append** (normal serving): ``record_*`` serializes the
    payload, fsyncs, done.  **replay** (inside ``restore_engine``): the
    engine re-executes the recorded operations, and each ``record_*``
    call *verifies* the re-executed payload against the next pending
    record instead of writing -- any mismatch means the replay diverged
    from the original run and raises :class:`RecoveryError`.  When the
    pending tail is exhausted the journal truncates any torn bytes and
    flips to append mode, so the restored engine journals seamlessly.

    ``writes=False`` keeps the sequence and the replay checks but touches
    no file: the journal of a mesh rank other than 0 (rank 0 writes).
    """

    def __init__(self, path: str, fh, mode: str, next_seq: int,
                 pending: Optional[List[dict]] = None, good_bytes: int = 0,
                 writes: bool = True):
        self.path = path
        self._fh = fh
        self.writes = writes
        self.mode = mode
        self._next_seq = next_seq
        self._pending = list(pending or [])
        self._good_bytes = good_bytes
        self.replayed = 0
        self.replayed_rounds = 0
        if self.mode == "replay" and not self._pending:
            self._switch_to_append()

    # -- constructors --------------------------------------------------
    @classmethod
    def create(cls, path: str, header: dict,
               writes: bool = True) -> "Journal":
        """Start a NEW journal epoch (truncating any previous file --
        resuming an old epoch goes through ``restore_engine``, never
        through a fresh engine construction)."""
        fh = None
        if writes:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            fh = open(path, "wb")
        j = cls(path, fh, "append", next_seq=0, writes=writes)
        j._append("header", header)
        return j

    @classmethod
    def for_replay(cls, path: str, pending: List[dict], next_seq: int,
                   good_bytes: int, writes: bool = True) -> "Journal":
        return cls(path, None, "replay", next_seq, pending, good_bytes,
                   writes=writes)

    # -- engine-facing hooks -------------------------------------------
    @property
    def replaying(self) -> bool:
        return self.mode == "replay"

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    def record_submit(self, payload: dict) -> None:
        self._record("submit", payload)

    def record_cancel(self, payload: dict) -> None:
        self._record("cancel", payload)

    def record_step(self, payload: dict) -> None:
        self._record("step", payload)

    def sync(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- internals -----------------------------------------------------
    def _append(self, kind: str, payload: dict) -> None:
        if not self.writes:
            self._next_seq += 1
            return
        rec = {"seq": self._next_seq, "kind": kind}
        rec.update(payload)
        rec = _jnorm(rec)
        rec["crc"] = _crc(rec)
        self._fh.write((json.dumps(rec, sort_keys=True,
                                   separators=(",", ":")) + "\n").encode())
        self._next_seq += 1
        self.sync()

    def _record(self, kind: str, payload: dict) -> None:
        if self.mode != "replay":
            self._append(kind, payload)
            return
        if not self._pending:
            raise RecoveryError(
                f"replay produced an extra {kind!r} record with no "
                f"journal record left to match it")
        exp = self._pending.pop(0)
        want = _jnorm(payload)
        if exp.get("kind") != kind:
            raise RecoveryError(
                f"replay divergence at seq {exp.get('seq')}: journal "
                f"has {exp.get('kind')!r}, replay produced {kind!r}")
        for key, val in want.items():
            if exp.get(key) != val:
                raise RecoveryError(
                    f"replay divergence at seq {exp.get('seq')} "
                    f"({kind}): field {key!r} recorded "
                    f"{exp.get(key)!r} but replay produced {val!r}")
        self.replayed += 1
        if kind == "step" and not exp.get("noop"):
            self.replayed_rounds += int(exp["k"])
        if not self._pending:
            self._switch_to_append()

    def _switch_to_append(self) -> None:
        self.mode = "append"
        if not self.writes:
            return
        fh = open(self.path, "r+b")
        fh.seek(self._good_bytes or 0, os.SEEK_SET)
        if self._good_bytes:
            fh.truncate()           # drop any torn tail before appending
        else:
            fh.seek(0, os.SEEK_END)
        self._fh = fh


# ---------------------------------------------------------------------------
# Snapshot codec
# ---------------------------------------------------------------------------

def _stats_to_dict(stats: EngineStats) -> dict:
    return dataclasses.asdict(stats)


def _stats_from_dict(d: dict) -> EngineStats:
    d = dict(d)
    d["shards"] = [ShardStats(**s) for s in d.get("shards", [])]
    return EngineStats(**d)


def snapshot_engine(engine) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Serialize the engine's complete serving state to ``(arrays,
    manifest)``: every slot-state leaf and the host staging / progress
    mirrors as tensors (state leaves where they live: ``keys`` on the
    host, the rest on the engine's device), and all host bookkeeping
    (requests with partial outputs, scheduler order, stats, spec / fault
    state) as a JSON-able manifest.  A meshed engine's slot state is the
    global one, gathered from every rank as CPU tensors (collective: every
    rank calls this)."""
    state = engine.state if engine.mesh is None else \
        serve_mesh.join_slot_state(engine.cfg, engine.state, engine.mesh)
    arrays = ckpt.flatten_tree(state, "state")
    for k, v in engine._smirror.items():
        arrays[_SMIRROR + ckpt.SEP + k] = torch.from_numpy(np.array(v))
    arrays["prompt_pos"] = torch.from_numpy(engine._prompt_pos.copy())
    arrays["rid_dev"] = torch.from_numpy(engine._rid_dev.copy())
    manifest = {
        "format": SNAPSHOT_FORMAT, "version": SNAPSHOT_VERSION,
        "time": time.time(),
        "round": engine.stats.decode_steps,
        "journal_seq": -1 if engine.journal is None
        else engine.journal.last_seq,
        "config": config_stamp(engine.cfg, engine.device),
        "engine": engine_knobs(engine),
        "next_rid": engine._next_rid,
        "requests": [dataclasses.asdict(engine.requests[rid])
                     for rid in sorted(engine.requests)],
        "scheduler": engine.scheduler.state_dict(),
        "staged": [None if r is None else r.rid for r in engine.staged],
        "current": [None if r is None else r.rid for r in engine.current],
        "finished": sorted(engine.finished),
        "dirty_slots": sorted(set(engine._dirty_slots)),
        "dead_shards": sorted(engine.dead_shards),
        "spec": {"active": engine._spec_active,
                 "hist": [list(t) for t in engine._spec_hist],
                 "off_calls": engine._spec_off_calls},
        "stats": _stats_to_dict(engine.stats),
        "faults": None if engine.faults is None
        else engine.faults.state_dict(),
    }
    return arrays, manifest


def snapshot_path(directory: str, round_: int) -> str:
    return os.path.join(directory, f"{_SNAP_PREFIX}{round_:08d}")


def save_snapshot(engine, directory: str, keep: int = 3) -> Optional[str]:
    """Atomic snapshot write (tmp dir + rename, sha256 checksum in the
    manifest) with keep-N GC of older generations.  Under a mesh every
    rank calls it and rank 0 alone writes; the others return None."""
    arrays, manifest = snapshot_engine(engine)
    if not engine.writer:
        return None
    packed, dtypes = ckpt.pack_arrays(arrays)
    manifest["dtypes"] = dtypes
    os.makedirs(directory, exist_ok=True)
    final = snapshot_path(directory, manifest["round"])
    with ckpt.atomic_dir(final) as tmp:
        np.savez(os.path.join(tmp, "arrays.npz"), **packed)
        manifest["checksum"] = "sha256:" + ckpt.sha256_file(
            os.path.join(tmp, "arrays.npz"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, default=_np_item)
    for r in list_snapshots(directory)[:-max(1, keep)]:
        shutil.rmtree(snapshot_path(directory, r), ignore_errors=True)
    return final


def list_snapshots(directory: str) -> List[int]:
    """Completed snapshot rounds in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d[len(_SNAP_PREFIX):]) for d in os.listdir(directory)
        if d.startswith(_SNAP_PREFIX) and not d.endswith(".tmp"))


def load_snapshot(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Load + integrity-check one snapshot generation (CPU tensors)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotCorruptError(f"{path}: unreadable manifest ({e})")
    recorded = manifest.get("checksum")
    npz = os.path.join(path, "arrays.npz")
    try:
        actual = "sha256:" + ckpt.sha256_file(npz)
    except OSError as e:
        raise SnapshotCorruptError(f"{path}: unreadable arrays.npz ({e})")
    if recorded != actual:
        raise SnapshotCorruptError(
            f"{path}: arrays.npz hash {actual} != manifest {recorded}")
    with np.load(npz) as raw:
        return ckpt.unpack_arrays(raw, manifest.get("dtypes", {})), manifest


def latest_snapshot(directory: str):
    """Newest restorable snapshot, falling back past corrupt
    generations.  Returns ``(arrays, manifest, path, skipped_rounds)``
    with Nones when no generation is restorable."""
    skipped: List[int] = []
    for r in reversed(list_snapshots(directory)):
        path = snapshot_path(directory, r)
        try:
            arrays, manifest = load_snapshot(path)
            return arrays, manifest, path, skipped
        except SnapshotCorruptError:
            skipped.append(r)
    return None, None, None, skipped


def apply_snapshot(engine, arrays: Dict[str, torch.Tensor],
                   manifest: dict) -> None:
    """Load a decoded snapshot into a freshly constructed engine: slot
    state, staging / progress mirrors, requests, scheduler queue, stats
    and fault state.  The engine must have been built with the
    snapshot's recorded knobs (``restore_engine`` guarantees this; a
    hand-built engine is checked and rejected on mismatch).  Every state
    leaf is checked against the fresh engine's tree -- the same paths,
    shapes and dtypes -- and placed on that leaf's device.  A meshed
    engine's snapshot holds the global state: each rank checks it against
    the global tree and keeps its own cut (collective: every rank calls
    this)."""
    _check_stamp("snapshot", manifest["config"],
                    _jnorm(config_stamp(engine.cfg, engine.device)))
    knobs = _jnorm(engine_knobs(engine))
    rec_knobs = manifest["engine"]
    diff = [k for k in set(knobs) | set(rec_knobs)
            if knobs.get(k) != rec_knobs.get(k)]
    if diff:
        raise RecoveryError(
            "engine knobs do not match the snapshot: " + ", ".join(
                f"{k}={knobs.get(k)!r} (snapshot {rec_knobs.get(k)!r})"
                for k in sorted(diff)))

    local = ckpt.flatten_tree(engine.state, "state")
    fresh = local if engine.mesh is None else ckpt.flatten_tree(
        serve_mesh.join_slot_state(engine.cfg, engine.state, engine.mesh),
        "state")
    snap_keys = {k for k in arrays if k.startswith("state" + ckpt.SEP)}
    if set(fresh) != snap_keys:
        raise RecoveryError(
            f"snapshot state tree does not match the engine's: missing "
            f"{sorted(set(fresh) - snap_keys)}, unexpected "
            f"{sorted(snap_keys - set(fresh))}")
    flat = {}
    for k, like in fresh.items():
        v = arrays[k]
        if v.dtype != like.dtype or v.shape != like.shape:
            raise RecoveryError(
                f"snapshot leaf {k} is {v.dtype} {tuple(v.shape)}, the "
                f"engine's is {like.dtype} {tuple(like.shape)}")
        flat[k] = v.to(local[k].device)
    state = ckpt.unflatten_tree(flat, "state")
    engine.state = state if engine.mesh is None else \
        serve_mesh.cut_slot_state(engine.cfg, state, engine.mesh)
    engine._smirror = {
        k[len(_SMIRROR) + len(ckpt.SEP):]: v.numpy().copy()
        for k, v in arrays.items()
        if k.startswith(_SMIRROR + ckpt.SEP)}
    engine._prompt_pos = arrays["prompt_pos"].numpy().copy()
    engine._rid_dev = arrays["rid_dev"].numpy().copy()

    from repro_torch.serving.engine import Request
    requests = {}
    for d in manifest["requests"]:
        req = Request(**d)
        requests[req.rid] = req
    engine.requests = requests
    engine.finished = {rid: requests[rid] for rid in manifest["finished"]}
    engine.current = [None if rid is None else requests[rid]
                      for rid in manifest["current"]]
    engine.staged = [None if rid is None else requests[rid]
                     for rid in manifest["staged"]]
    engine.scheduler.load_state_dict(manifest["scheduler"], requests)
    engine._next_rid = int(manifest["next_rid"])
    engine._dirty_slots = list(manifest["dirty_slots"])
    engine.dead_shards = set(manifest["dead_shards"])
    spec = manifest["spec"]
    engine._spec_active = bool(spec["active"])
    engine._spec_hist = [tuple(t) for t in spec["hist"]]
    engine._spec_off_calls = int(spec["off_calls"])
    engine.stats = _stats_from_dict(manifest["stats"])
    if engine.faults is not None and manifest.get("faults"):
        engine.faults.load_state_dict(manifest["faults"])
    engine._last_snapshot_round = int(manifest["round"])


# ---------------------------------------------------------------------------
# Restore: snapshot + journal-tail replay
# ---------------------------------------------------------------------------

def _ctor_kwargs(knobs: dict, *, speculative=None, draft_params=None):
    """Recorded knobs -> ServingEngine constructor kwargs."""
    from repro_torch.serving import draft as draft_lib
    spec = speculative
    if spec is None and knobs.get("speculative"):
        name = knobs["speculative"]
        if name != "ngram":
            raise RecoveryError(
                f"the journal records a {name!r} draft source, which "
                f"cannot be rebuilt from its name -- pass "
                f"speculative=<instance> (and draft_params) to restore")
        spec = draft_lib.NGramDraft(int(knobs["draft_len"]),
                                    int(knobs.get("draft_ngram") or 2))
    faults = None
    if knobs.get("faults"):
        fkw = dict(knobs["faults"])
        for key in ("nan_at", "shard_crash_at"):
            fkw[key] = tuple(tuple(t) for t in fkw.get(key) or ())
        faults = FaultInjector(FaultConfig(**fkw))
    return dict(
        max_batch=knobs["max_batch"], max_len=knobs["max_len"],
        seed=knobs["seed"], decode_block=knobs["decode_block"],
        prompt_chunk=knobs["prompt_chunk"], speculative=spec,
        draft_params=draft_params,
        max_queue=knobs["max_queue"],
        high_watermark=knobs["high_watermark"],
        low_watermark=knobs["low_watermark"],
        aging_rounds=knobs["aging_rounds"],
        max_retries=knobs["max_retries"],
        retry_backoff=knobs["retry_backoff"],
        spec_accept_floor=knobs["spec_accept_floor"],
        spec_window=knobs["spec_window"],
        spec_cooldown=knobs["spec_cooldown"],
        faults=faults, mesh=knobs["mesh"],
        fuse_block=knobs["fuse_block"], tune=None)


def restore_engine(recover_dir: str, cfg, params, *, speculative=None,
                   draft_params=None, device="cuda"):
    """Rebuild a :class:`~repro_torch.serving.engine.ServingEngine` from a
    recovery directory on a fresh process: load the newest good
    snapshot (falling back past corrupt generations), then re-execute
    the journal tail -- every submit / cancel / step after the
    snapshot's ``journal_seq`` -- through the real engine code paths,
    verifying each replayed operation against its record.  The returned
    engine carries a ``recovery_report`` dict (snapshot used, corrupt
    generations skipped, records / rounds replayed, recovery wall time,
    split into ``load_s`` -- construction and snapshot -- and
    ``replay_s``) and continues journaling and snapshotting where the
    dead process stopped; its streams are bit-identical to an
    uninterrupted run.

    ``cfg`` and ``params`` are caller-owned (model weights are a
    *training* checkpoint's job and are not in the serving snapshot);
    ``cfg`` and ``device`` must carry the stamp the journal recorded.
    """
    from repro_torch.serving import engine as engine_mod
    t0 = time.perf_counter()
    jpath = os.path.join(recover_dir, JOURNAL_NAME)
    if not os.path.exists(jpath):
        raise RecoveryError(
            f"no journal at {jpath}: the directory was never armed for "
            f"recovery (construct the engine with recover_dir=...)")
    header, records, dropped, good_bytes = read_journal(jpath)
    if header is None:
        raise RecoveryError(f"{jpath}: no readable header record")
    _check_stamp("journal", dict(header["config"]),
                    _jnorm(config_stamp(cfg, device)))
    kw = _ctor_kwargs(dict(header["engine"]), speculative=speculative,
                      draft_params=draft_params)
    eng = engine_mod.ServingEngine(cfg, params, device=device, **kw)
    if eng.mesh is not None:
        # a meshed journal: every rank reads once rank 0 has written all
        # it will (its last step record and snapshot), and rank 0 appends
        # once every rank has read
        eng.mesh.barrier()
        header, records, dropped, good_bytes = read_journal(jpath)
        eng.mesh.barrier()
    eng.recover_dir = recover_dir
    snapcfg = header.get("snapshot") or {}
    eng.snapshot_every = int(snapcfg.get("every", eng.snapshot_every))
    eng.snapshot_keep = int(snapcfg.get("keep", eng.snapshot_keep))

    arrays, manifest, spath, skipped = latest_snapshot(recover_dir)
    snap_seq = -1
    if manifest is not None:
        apply_snapshot(eng, arrays, manifest)
        snap_seq = int(manifest["journal_seq"])
    tail = [r for r in records if r["seq"] > snap_seq]
    next_seq = (records[-1]["seq"] if records else header["seq"]) + 1
    eng.journal = Journal.for_replay(jpath, tail, next_seq, good_bytes,
                                     writes=eng.writer)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t1 = time.perf_counter()

    for rec in tail:
        kind = rec["kind"]
        if kind == "submit":
            rid = eng.submit(list(rec["prompt"]), max_new=rec["max_new"],
                             temperature=rec["temperature"],
                             top_k=rec["top_k"], top_p=rec["top_p"],
                             eos=rec["eos"], priority=rec["priority"],
                             deadline=rec["deadline"])
            if rid != rec["rid"]:
                raise RecoveryError(
                    f"replayed submit produced rid {rid}, journal seq "
                    f"{rec['seq']} recorded rid {rec['rid']}")
        elif kind == "cancel":
            eng.cancel(rec["rid"])
        elif kind == "step":
            eng.step(rec["k"])
        else:
            raise RecoveryError(
                f"unknown journal record kind {kind!r} at seq "
                f"{rec['seq']}")
    if eng.journal.replaying:
        raise RecoveryError(
            "journal tail not fully consumed after replay -- the replay "
            "executed fewer operations than were recorded")
    t2 = time.perf_counter()
    eng.recovery_report = {
        "snapshot": spath,
        "snapshot_round": None if manifest is None else manifest["round"],
        "corrupt_snapshots_skipped": skipped,
        "journal_records": len(records),
        "replayed_records": len(tail),
        "replayed_rounds": eng.journal.replayed_rounds,
        "dropped_tail_records": dropped,
        "recovery_s": t2 - t0,
        "load_s": t1 - t0,
        "replay_s": t2 - t1,
    }
    return eng
