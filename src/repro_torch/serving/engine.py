"""Serving engine: continuous batching as one superstep per host round-trip.

The port of ``repro.serving.engine`` for a single device.  Per ``step()``:
the host sweeps deadlines and stages queued requests into per-slot
staging buffers (device tensors), then ONE ``lm.superstep`` call runs K
rounds of re-admission -> token select -> layer kernels ->
sample-or-teacher-force -> retire on the device, and the host drains the
(B, K) token and request-id planes with one device-to-host copy,
retires finished requests, quarantines rows the non-finite guard killed
(bounded retry with backoff) and restocks staging.

Greedy streams equal the single-request ``generate_one`` reference token
for token, under any admission order, mid-flight arrival, slot reuse and
``prompt_chunk``.

With ``speculative`` set (a ``serving.draft`` source, or ``"ngram"``),
decoding rows propose up to ``draft_len`` tokens a round and the
superstep verifies them in one chunk pass per layer
(``lm.decode_verify``), rolling the recurrent state back to the last
accepted position with one gather; the drain planes grow to (B, K, S+1).
Streams stay identical to the non-speculative engine's, greedy and
seeded.  A rolling accept-rate floor (``spec_accept_floor``) turns
drafting off when it stops paying (``_adapt_speculation``).

The robustness layer follows the reference's:

  * ``tune`` resolves an autotuned plan (``serving/tuning.py``) measured
    on this engine's device; it supplies ``fuse_block`` and the K / C
    defaults, and explicit arguments win.
  * ``faults`` (a ``serving.faults.FaultInjector``) injects NaN state
    corruption, dropped staging uploads, straggler stalls and shard
    crashes at the reference's points in ``step`` -- seeded, and fully
    inert when None.  A row whose state goes non-finite is killed by the
    superstep's health guard and its request re-enqueued under a bounded
    retry budget (``_quarantine`` -> ``_requeue``).
  * ``recover_dir`` journals every submit / cancel / step to a
    write-ahead log and snapshots the serving state every
    ``snapshot_every`` rounds; ``ServingEngine.restore`` resumes a killed
    run with streams and round clock bit-identical to an uninterrupted
    one (``serving/recovery.py``).

With ``faults=None`` and ``recover_dir=None`` none of it runs: the same
launches and the same host reads as without the layer.

``mesh="DxM"`` serves on a ``data x model`` world, one process per mesh
position (``distributed/serve_mesh.py``): the slot pool splits into
``data`` contiguous row groups (shard s owns rows ``[s*B/D, (s+1)*B/D)``)
and, for the minRNN LMs, ``model`` splits the gate, ``down`` and MLP
projections by ``d_hidden`` / ``d_ff``.  Every rank runs this host logic
on the same submissions and holds its own rows on its device; each drain
gathers the planes over the data shards, so every host decides alike.  A
``shard_crash`` kills one data shard's rows and its requests finish on
the survivors; without a mesh the engine is one shard and a crash is a
total outage.  ``fuse_block="off"`` serves on the cell-only kernel tier;
the attention trunk with a minRNN mixer (gemma-2b-mingru) and a
tensor-parallel mesh always do.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import serve_mesh
from repro_torch.models import lm
from repro_torch.serving import draft as draft_lib
from repro_torch.serving import recovery, sampling, tuning
from repro_torch.serving.scheduler import (ADMITTED, REJECTED_QUEUE_FULL,
                                           AdmissionScheduler, EngineStats,
                                           SchedulerConfig, ShardStats)

QUEUED = "QUEUED"
STAGED = "STAGED"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
CANCELLED = "CANCELLED"
TIMED_OUT = "TIMED_OUT"
FAILED = "FAILED"
SHED = "SHED"
TERMINAL_STATUSES = frozenset(
    {COMPLETED, CANCELLED, TIMED_OUT, FAILED, SHED})


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    priority: int = 1
    deadline: Optional[int] = None
    status: str = QUEUED
    verdict: Optional[str] = None
    retries: int = 0
    not_before: int = 0
    submitted_s: float = 0.0
    submit_round: int = 0
    first_token_s: float = 0.0
    first_round: int = 0
    admit_seq: int = -1


class EngineStallError(RuntimeError):
    """``run_to_completion`` exceeded ``max_steps`` with work still
    pending.  ``.report`` carries the queue + per-slot occupancy snapshot
    (``ServingEngine.occupancy_report``)."""

    def __init__(self, message: str, report: Dict[str, Any]):
        super().__init__(message)
        self.report = report


_STAGE_FIELDS = ("s_valid", "s_prompt", "s_prompt_len", "s_rid",
                 "s_remaining", "s_eos", "s_temperature", "s_top_k",
                 "s_top_p")


# the superstep's scalar counters the host reads after every call
_COUNTERS = ("prefill_steps", "prefill_rounds", "wasted_slot_steps",
             "nonfinite_decode_rounds")
_SPEC_COUNTERS = ("draft_proposed", "draft_accepted", "emit_rounds")


class ServingEngine:
    def __init__(self, cfg, params, *, max_batch: int = 8,
                 max_len: int = 2048, seed: int = 0,
                 decode_block: Optional[int] = None,
                 prompt_chunk: Optional[int] = None,
                 max_queue: int = 0, high_watermark: float = 1.0,
                 low_watermark: float = 0.5, aging_rounds: int = 64,
                 max_retries: int = 1, retry_backoff: int = 8,
                 fuse_block: Optional[str] = None, device="cuda",
                 speculative=None, draft_len: int = 4, draft_params=None,
                 spec_accept_floor: Optional[float] = None,
                 spec_window: int = 8, spec_cooldown: int = 0,
                 mesh=None, faults=None, tune=None,
                 recover_dir: Optional[str] = None,
                 snapshot_every: int = 8, snapshot_keep: int = 3):
        self.device = resolve_device(device)
        # autotuned plan (serving/tuning.py): None (no plan), "auto"
        # (discovery order), a path, or a plan dict, for this device.  It
        # supplies the decode tier and the K / C defaults -- explicit
        # arguments always win.
        self.tune_plan = tuning.resolve_plan(cfg, tune, self.device)
        if self.tune_plan is not None:
            cfg = tuning.apply_plan(cfg, self.tune_plan)
            if decode_block is None:
                decode_block = self.tune_plan.get("decode_block")
            if prompt_chunk is None:
                prompt_chunk = self.tune_plan.get("prompt_chunk")
        if fuse_block is not None and fuse_block != cfg.fuse_block:
            cfg = cfg.replace(fuse_block=fuse_block)
        self.decode_block = max(1, int(decode_block or 1))
        self.prompt_chunk = max(1, int(prompt_chunk or 1))
        if self.prompt_chunk > 1 and not lm.supports_prompt_packing(cfg):
            raise ValueError(
                f"prompt_chunk={self.prompt_chunk} requires a recurrent-"
                f"state arch (block_kind='minrnn')")
        # speculative decoding: a draft source name ("ngram") or instance
        if isinstance(speculative, str):
            speculative = draft_lib.make(speculative, draft_len)
        if speculative is not None and not lm.supports_prompt_packing(cfg):
            raise ValueError(
                f"speculative decoding requires a recurrent-state arch "
                f"(block_kind='minrnn'); {cfg.name} has "
                f"block_kind={cfg.block_kind!r}")
        self.cfg = cfg
        # the serving mesh (``--mesh DxM``): this process is one rank of a
        # data x model world; None keeps the one-device path as it was
        self.mesh_plan = serve_mesh.MeshPlan.parse(mesh)
        self.mesh = None
        if self.mesh_plan is not None:
            plan = self.mesh_plan
            if max_batch % plan.data != 0:
                raise ValueError(
                    f"max_batch ({max_batch}) must divide over the data "
                    f"axis ({plan.data}): each shard owns "
                    f"max_batch/data contiguous slot rows")
            if plan.model > 1:
                if cfg.block_kind != "minrnn":
                    raise ValueError(
                        f"tensor-parallel serving (model axis "
                        f"{plan.model} > 1) shards d_hidden and requires "
                        f"block_kind='minrnn'; {cfg.name} has "
                        f"block_kind={cfg.block_kind!r}")
                if not serve_mesh._tp_shards_hidden(cfg, plan):
                    raise ValueError(
                        f"d_hidden of {cfg.name} does not divide over "
                        f"the model axis ({plan.model}); pick a model "
                        f"size that divides d_hidden")
            self.mesh = plan.build()
        self.dp = self.mesh_plan.data if self.mesh_plan is not None else 1
        self._rows_per_shard = max_batch // self.dp
        # this rank's rows of the slot pool (all of them without a mesh)
        shard = 0 if self.mesh is None else self.mesh.data_index
        self._rows = serve_mesh.shard_rows(shard, self._rows_per_shard)
        # elements of the drained planes where this rank's own differed
        # from model rank 0's (tensor parallelism; stays 0 unless the
        # model ranks' bits part)
        self.tp_plane_mismatches = 0
        self.params = lm.tree_to(params, self.device)
        if self.mesh is not None:
            self.params = serve_mesh.shard_params(self.params, cfg,
                                                  self.mesh)
        # the engine owns the params for its lifetime: bind them for the
        # kernels once, not once per round (under TP: the rank's blocks,
        # on the cell tier)
        with mesh_ctx.serving_tp(None if self.mesh is None
                                 else self.mesh.model_group):
            self.layers = lm.bind_layers(self.params, cfg)
        self.max_batch = max_batch
        self.max_len = max_len
        self.seed = int(seed)
        self.draft = speculative
        self.draft_params = draft_params if draft_params is not None \
            else getattr(speculative, "params", None)
        if self.draft_params is not None:
            self.draft_params = lm.tree_to(self.draft_params, self.device)
            if hasattr(self.draft, "bind"):     # its own kernel binding
                self.draft.bind(self.draft_params)
        self.spec_accept_floor = spec_accept_floor
        self.spec_window = max(1, int(spec_window))
        self.spec_cooldown = max(0, int(spec_cooldown))
        self._spec_active = True
        self._spec_hist: List = []      # (proposed, accepted) per call
        self._spec_off_calls = 0
        # the global B-row state; a rank keeps its cut (the per-slot keys
        # depend on the global row)
        state = lm.init_slot_state(cfg, max_batch, max_len, seed=seed,
                                   draft=self.draft, device=self.device)
        self.state = state if self.mesh is None else \
            serve_mesh.cut_slot_state(cfg, state, self.mesh)
        self.scheduler = AdmissionScheduler(SchedulerConfig(
            max_batch=max_batch, max_queue=max_queue,
            high_watermark=high_watermark, low_watermark=low_watermark,
            aging_rounds=aging_rounds))
        self.stats = EngineStats(
            prompt_chunk=self.prompt_chunk,
            shards=[ShardStats() for _ in range(self.dp)])
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff = max(0, int(retry_backoff))
        # chaos injector (None = fully inert)
        self.faults = faults
        # DP-shard failover: data shards whose rows a scheduled
        # shard_crash killed.  Dead rows never stage again (they keep
        # stepping, counted as waste); their requests drain onto the
        # survivors -- without a mesh there are none
        self.dead_shards: set = set()
        self._next_rid = 0
        self.current: List[Optional[Request]] = [None] * max_batch
        self.staged: List[Optional[Request]] = [None] * max_batch
        self.finished: Dict[int, Request] = {}
        self.requests: Dict[int, Request] = {}
        # host mirrors of the staging tensors, all B rows (authoritative
        # on the host; the device only consumes them, flipping s_valid)
        self._smirror = {k: state[k].cpu().numpy().copy()
                         for k in _STAGE_FIELDS}
        del state
        self._dirty_slots: List[int] = []
        self._prompt_pos = np.zeros((max_batch,), np.int32)
        self._rid_dev = np.full((max_batch,), -1, np.int32)

        # crash recovery (serving/recovery.py): with ``recover_dir`` set
        # every submit / cancel / step goes to a write-ahead journal and
        # the serving state is snapshotted every ``snapshot_every``
        # device rounds.  Constructing with recover_dir starts a NEW
        # journal epoch (truncating any prior one); resuming goes through
        # ``restore``.
        self.snapshot_every = max(1, int(snapshot_every))
        self.snapshot_keep = max(1, int(snapshot_keep))
        self.recover_dir = recover_dir
        self._last_snapshot_round = 0
        self.journal = None
        self.recovery_report: Optional[Dict[str, Any]] = None
        if recover_dir is not None:
            os.makedirs(recover_dir, exist_ok=True)
            # under a mesh rank 0 alone writes; the other ranks' journals
            # keep the sequence and write nothing
            self.journal = recovery.Journal.create(
                os.path.join(recover_dir, recovery.JOURNAL_NAME),
                recovery.engine_header(self), writes=self.writer)

    # ------------------------------------------------------------------
    @property
    def kernel_tier(self) -> str:
        """"block-fused" (one whole-block kernel launch per layer per
        round), "cell-fused" (one cell-only kernel launch per layer per
        round) or "unfused" (plain PyTorch).  Tensor-parallel serving
        splits the row-parallel products, whose all-reduce stays outside
        any kernel, so a TP mesh reports the cell tier."""
        tier = lm.kernel_tier(self.cfg)
        if tier == "block-fused" and self.mesh_plan is not None \
                and self.mesh_plan.model > 1:
            return "cell-fused"
        return tier

    @property
    def writer(self) -> bool:
        """True on the one process that writes journals and snapshots:
        rank 0 of a mesh, or the engine without one."""
        return self.mesh is None or self.mesh.rank == 0

    @classmethod
    def restore(cls, recover_dir: str, cfg, params, *, speculative=None,
                draft_params=None, device="cuda") -> "ServingEngine":
        """Rebuild an engine from a crash-recovery directory on a fresh
        process: newest good snapshot + journal-tail replay
        (``serving.recovery.restore_engine``).  Its streams are
        bit-identical to an uninterrupted run and it keeps journaling
        and snapshotting where the dead process stopped;
        ``engine.recovery_report`` says what recovery did.  A journal of
        a meshed engine restores on every rank of a world of its mesh."""
        return recovery.restore_engine(recover_dir, cfg, params,
                                       speculative=speculative,
                                       draft_params=draft_params,
                                       device=device)

    def _service_rounds(self, req: Request) -> int:
        """Rounds a request holds a row: packed prefill plus decode, less
        the round where both meet.  Under speculation an upper bound (a
        round commits at least one token)."""
        return -(-len(req.prompt) // self.prompt_chunk) + req.max_new - 1

    def _est_finish_round(self, req: Request) -> int:
        """The device round by which ``req`` could finish, the work ahead
        of it placed on the soonest-freeing rows; an upper bound under
        speculation, used only to shed deadlines it cannot meet.  Rows of
        a crashed shard never free up and are left out."""
        live = [s for s in range(self.max_batch)
                if s // self._rows_per_shard not in self.dead_shards]
        if not live:
            return 1 << 62      # total outage: nothing can ever finish
        etas = [self._row_eta(s) for s in live]
        for i, slot in enumerate(live):
            if self.staged[slot] is not None:
                etas[i] += self._service_rounds(self.staged[slot])
        heapq.heapify(etas)
        for ahead in self.scheduler.waiting:
            heapq.heappush(etas,
                           heapq.heappop(etas) + self._service_rounds(ahead))
        return (self.stats.decode_steps + min(etas)
                + self._service_rounds(req))

    def submit(self, prompt: List[int], max_new: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos: Optional[int] = None, priority: int = 1,
               deadline: Optional[int] = None) -> int:
        """Submit a request; returns its rid.  The admission verdict lands
        on ``engine.requests[rid].verdict``."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new - 1 > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) needs "
                f"{len(prompt) + max_new - 1} cache positions, exceeding "
                f"engine max_len ({self.max_len})")
        sampling.validate_controls(temperature, top_k, top_p)
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be a positive device-round "
                             f"budget, got {deadline!r}")
        rid = self._next_rid
        if self.journal is not None:
            # write-ahead: durable BEFORE the engine mutates; the rid is
            # deterministic, so the record can promise it
            self.journal.record_submit({
                "rid": rid, "round": self.stats.decode_steps,
                "prompt": [int(t) for t in prompt],
                "max_new": int(max_new),
                "temperature": float(temperature), "top_k": int(top_k),
                "top_p": float(top_p),
                "eos": None if eos is None else int(eos),
                "priority": int(priority),
                "deadline": None if deadline is None else int(deadline)})
        self._next_rid += 1
        req = Request(rid, [int(t) for t in prompt], max_new, temperature,
                      top_k, top_p, eos, priority=priority)
        req.submitted_s = time.perf_counter()
        req.submit_round = self.stats.decode_steps
        if deadline is not None:
            req.deadline = req.submit_round + int(deadline)
        self.requests[rid] = req
        self.stats.submitted += 1
        est = self._est_finish_round(req) if req.deadline is not None \
            else None
        req.verdict = self.scheduler.submit(
            req, now_round=req.submit_round, est_finish=est)
        if req.verdict == ADMITTED:
            req.status = QUEUED
            self.stats.observe_queue(len(self.scheduler))
        else:
            self._retire(req, SHED)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is; an in-flight one keeps the
        tokens already drained.  True if it became CANCELLED."""
        if self.journal is not None:
            # journaled even when a no-op: replay re-executes the call
            self.journal.record_cancel({"rid": int(rid),
                                        "round": self.stats.decode_steps})
        req = self.requests.get(rid)
        if req is None or req.done:
            return False
        if self.scheduler.remove(req):
            self._retire(req, CANCELLED)
            return True
        if req.slot is not None and self.staged[req.slot] is req:
            self._unstage(req.slot)
            self._retire(req, CANCELLED)
            return True
        if req.slot is not None and self.current[req.slot] is req:
            self._kill_inflight(req, CANCELLED)
            return True
        return False

    # ------------------------------------------------------------------
    # Staging
    # ------------------------------------------------------------------
    def _row_eta(self, slot: int) -> int:
        """Rounds until this row frees (0 when idle): the prompt tokens the
        device has not consumed yet (the synced ``prompt_pos`` mirror), C
        a round, plus the tokens still to emit -- an upper bound under
        speculation, where a round commits one token or more."""
        req = self.current[slot]
        if req is None:
            return 0
        if req.out:
            prompt_left = 0
        else:
            consumed = int(self._prompt_pos[slot]) \
                if int(self._rid_dev[slot]) == req.rid else 0
            prompt_left = max(0, len(req.prompt) - consumed)
        return -(-prompt_left // self.prompt_chunk) + req.max_new \
            - len(req.out)

    def _stage(self):
        """Park queued requests into empty staging buffers in scheduler
        order; rows of a crashed shard never stage.

        Under a data-parallel mesh a row belongs to one shard, so
        admission also places: the least-loaded shard first (load = the
        summed ``_row_eta`` of its rows plus the service rounds of its
        parked requests), then the soonest-freeing row, then the row
        index.  With one shard this is the ``(eta, row)`` order."""
        empty = [i for i in range(self.max_batch)
                 if self.staged[i] is None
                 and i // self._rows_per_shard not in self.dead_shards]
        now = self.stats.decode_steps
        group = self.scheduler.take(len(empty), now_round=now)
        if not group and self.scheduler.waiting \
                and not any(self.current) and not any(self.staged):
            group = self.scheduler.take(len(empty), now_round=now,
                                        ignore_backoff=True)
        if not group:
            return
        load = [0] * self.dp
        for i in range(self.max_batch):
            load[i // self._rows_per_shard] += self._row_eta(i)
            if self.staged[i] is not None:
                load[i // self._rows_per_shard] += \
                    self._service_rounds(self.staged[i])
        m = self._smirror
        for req in group:
            empty.sort(key=lambda i: (load[i // self._rows_per_shard],
                                      self._row_eta(i), i))
            slot = empty.pop(0)
            load[slot // self._rows_per_shard] += self._service_rounds(req)
            req.slot = slot
            req.status = STAGED
            req.admit_seq = self.stats.admitted
            self.staged[slot] = req
            m["s_prompt"][slot, :] = 0
            m["s_prompt"][slot, :len(req.prompt)] = req.prompt
            m["s_prompt_len"][slot] = len(req.prompt)
            m["s_rid"][slot] = req.rid
            m["s_remaining"][slot] = req.max_new
            m["s_eos"][slot] = -1 if req.eos is None else req.eos
            m["s_temperature"][slot] = req.temperature
            m["s_top_k"][slot] = req.top_k
            m["s_top_p"][slot] = req.top_p
            m["s_valid"][slot] = True
            self.stats.admitted += 1
            self._dirty_slots.append(slot)

    def _unstage(self, slot: int):
        req = self.staged[slot]
        self.staged[slot] = None
        req.slot = None
        self._smirror["s_valid"][slot] = False
        self._dirty_slots.append(slot)

    def _upload_staging(self):
        """Push staged rows to the device: the (B,) control vectors whole,
        the (B, max_len) prompt matrix only for the dirty rows.

        The ``drop_upload`` fault intercepts here: a dropped slot's
        prompt row is not uploaded and its ``s_valid`` is masked False for
        this call (the device must never arm a row whose prompt it does
        not have); the slot stays dirty, so the next call retries and the
        request arms one superstep late."""
        if not self._dirty_slots:
            return
        rows = sorted(set(self._dirty_slots))
        dropped: List[int] = []
        if self.faults is not None:
            rows, dropped = self.faults.drop_upload(
                self.stats.decode_calls, rows)
        lo, hi = self._rows.start, self._rows.stop
        mine = [r for r in rows if lo <= r < hi]
        if mine:
            idx = torch.as_tensor([r - lo for r in mine], device=self.device)
            self.state["s_prompt"][idx] = torch.as_tensor(
                self._smirror["s_prompt"][mine]).to(self.device)
        s_valid = self._smirror["s_valid"]
        if dropped:
            s_valid = s_valid.copy()
            s_valid[dropped] = False
        for k in _STAGE_FIELDS:
            if k != "s_prompt":
                src = s_valid if k == "s_valid" else self._smirror[k]
                self.state[k] = torch.as_tensor(src[lo:hi]).to(self.device)
        self._dirty_slots = list(dropped)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def _promote(self, slot: int) -> Request:
        prev = self.current[slot]
        assert prev is None or prev.done, \
            "device armed a row whose request the host still thinks is live"
        req = self.staged[slot]
        assert req is not None
        self.current[slot] = req
        self.staged[slot] = None
        req.status = RUNNING
        return req

    def _retire(self, req: Request, status: str):
        req.done = True
        req.status = status
        if req.slot is not None:
            if self.current[req.slot] is req:
                self.current[req.slot] = None
            req.slot = None
        self.finished[req.rid] = req
        if status == COMPLETED:
            self.stats.completed += 1
        elif status == CANCELLED:
            self.stats.cancelled += 1
        elif status == TIMED_OUT:
            self.stats.timed_out += 1
        elif status == FAILED:
            self.stats.failed += 1
        elif status == SHED:
            if req.verdict == REJECTED_QUEUE_FULL:
                self.stats.rejected += 1
            else:
                self.stats.shed += 1

    def _finish(self, req: Request, now: float, last_round: int):
        self._retire(req, COMPLETED)
        self.stats.record_completion(len(req.out), req.first_round,
                                     last_round, req.first_token_s, now)

    def _kill_inflight(self, req: Request, status: str):
        self._kill_rows(req.slot, req.slot + 1)
        self._retire(req, status)

    def _kill_rows(self, start: int, stop: int):
        """Mark slot rows [start, stop) dead between supersteps, on the
        rank that holds them (a new tensor: the superstep may still hold
        the old one)."""
        lo = self._rows.start
        start, stop = max(start, lo) - lo, min(stop, self._rows.stop) - lo
        if start >= stop:
            return
        alive = self.state["alive"].clone()
        alive[start:stop] = False
        self.state["alive"] = alive

    def _sweep_deadlines(self):
        now = self.stats.decode_steps
        for req in [r for r in self.scheduler.waiting
                    if r.deadline is not None and now >= r.deadline]:
            self.scheduler.remove(req)
            self._retire(req, TIMED_OUT)
        for slot in range(self.max_batch):
            req = self.staged[slot]
            if req is not None and req.deadline is not None \
                    and now >= req.deadline:
                self._unstage(slot)
                self._retire(req, TIMED_OUT)
            req = self.current[slot]
            if req is not None and req.deadline is not None \
                    and now >= req.deadline:
                self._kill_inflight(req, TIMED_OUT)

    def _corrupt_slots(self, slots: List[int]):
        """The ``corrupt_state`` fault: NaN into the recurrent state rows
        of ``slots`` (new tensors, never in place on one a bound kernel
        may hold).  The superstep's health guard kills the poisoned rows
        on their next round.  Under a mesh each rank poisons the rows it
        holds, and under TP its whole ``h`` block of them: every model
        rank of a row sees the fault."""
        lo = self._rows.start
        slots = [s - lo for s in slots if s in self._rows]
        if not slots:
            return
        cache = dict(self.state["cache"])
        touched = False
        for name in lm._RECURRENT_CACHE_KEYS:
            leaf = cache.get(name)
            if leaf is not None and leaf.is_floating_point():
                leaf = leaf.clone()
                leaf[:, torch.as_tensor(slots, device=leaf.device)] = \
                    float("nan")
                cache[name] = leaf
                touched = True
        if touched:
            self.state["cache"] = cache

    def _requeue(self, req: Request, round_: int, *, count_retry: bool,
                 backoff: bool) -> bool:
        """Re-enqueue a request whose slot died under it, or retire it if
        it cannot be retried: the shared tail of quarantine (the health
        guard's kill: ``count_retry`` -- the request's input may be the
        poison, so it burns retry budget and backs off exponentially) and
        shard failover (an infrastructure death: no budget, re-eligible
        at once).  True if the request went back to QUEUED."""
        if req.deadline is not None and round_ >= req.deadline:
            self._retire(req, TIMED_OUT)
            return False
        if count_retry and req.retries >= self.max_retries:
            self._retire(req, FAILED)
            return False
        verdict = self.scheduler.submit(req, now_round=round_)
        req.verdict = verdict
        if verdict != ADMITTED:
            self._retire(req, FAILED)   # no queue room for the retry
            return False
        if count_retry:
            req.retries += 1
            self.stats.retried += 1
        req.out = []        # the retry restarts the stream from scratch
        req.status = QUEUED
        req.not_before = round_ + (
            self.retry_backoff * (2 ** (req.retries - 1))
            if backoff else 0)
        self.stats.observe_queue(len(self.scheduler))
        return True

    def _crash_shard(self, shard: int, round_: int):
        """The ``shard_crash`` fault fired: mark ``shard``'s rows dead for
        good and drain its staged and in-flight requests back through the
        requeue path (no retry budget burned), onto the surviving shards.
        The dead rows keep stepping as that shard's
        ``wasted_slot_steps``, so the per-shard slot-step identity holds.
        With one shard this is a total outage: the requests wait in the
        queue and ``run_to_completion`` reports the stall."""
        self.dead_shards.add(shard)
        self.stats.shard_crashes += 1
        rows = serve_mesh.shard_rows(shard, self._rows_per_shard)
        self._kill_rows(rows.start, rows.stop)
        for slot in rows:
            parked = self.staged[slot]
            if parked is not None:
                self._unstage(slot)
                if self._requeue(parked, round_, count_retry=False,
                                 backoff=False):
                    self.stats.failover_requeued += 1
            req = self.current[slot]
            if req is not None and not req.done:
                self.current[slot] = None
                req.slot = None
                if self._requeue(req, round_, count_retry=False,
                                 backoff=False):
                    self.stats.failover_requeued += 1

    def _quarantine(self, slot: int, round_: int, s_valid_np, dirty):
        """The non-finite guard killed this row: re-enqueue its request
        under the retry budget (exponential backoff) or retire it FAILED."""
        self.stats.quarantined += 1
        req = self.current[slot]
        if req is None or req.done:
            # the victim armed mid-superstep from staging (it emitted
            # nothing before the kill, so the drain never promoted it)
            if self.staged[slot] is not None and not s_valid_np[slot] \
                    and slot not in dirty:
                req = self._promote(slot)
            else:
                return
        self.current[slot] = None
        req.slot = None
        self._requeue(req, round_, count_retry=True, backoff=True)

    # ------------------------------------------------------------------
    # The superstep
    # ------------------------------------------------------------------
    def _chunk_rounds(self, k: int) -> List[bool]:
        """Which of the next ``k`` rounds may have a row prefilling, from
        what the host knows: an armed row's prompt position, and a staged
        row's earliest (round 0 on an empty slot, else 1) and latest
        (the armed request's length cap) arming round.  Marked rounds run
        the C-token chunk kernel; the guess errs only towards marking, and
        a miss would cost speed, not tokens (``lm.superstep``)."""
        c = self.prompt_chunk
        marked = [False] * k

        def mark(first: int, n_rounds: int):
            for j in range(max(0, first), min(k, first + n_rounds)):
                marked[j] = True

        for slot in range(self.max_batch):
            cur, parked = self.current[slot], self.staged[slot]
            arm_first = arm_last = 0
            if cur is not None:
                if not cur.out:
                    consumed = int(self._prompt_pos[slot]) \
                        if int(self._rid_dev[slot]) == cur.rid else 0
                    mark(0, -(-max(0, len(cur.prompt) - consumed) // c))
                arm_first, arm_last = 1, self._row_eta(slot)
            if parked is not None:
                mark(arm_first, arm_last - arm_first
                     + -(-len(parked.prompt) // c))
        return marked

    def _adapt_speculation(self, proposed: int, accepted: int):
        """Rolling accept-rate floor: when a window of ``spec_window``
        drafting calls accepts below ``spec_accept_floor`` of what they
        proposed, drafting turns off (the plain superstep runs) instead
        of paying an (S+1)-wide verify for about one token a round.  With
        ``spec_cooldown > 0`` it probes again after that many calls.
        Streams are the same either way."""
        if self.draft is None or self.spec_accept_floor is None:
            return
        if not self._spec_active:
            self._spec_off_calls += 1
            if self.spec_cooldown and \
                    self._spec_off_calls >= self.spec_cooldown:
                self._spec_active = True
                self._spec_off_calls = 0
                self._spec_hist = []
            return
        if proposed <= 0:
            return
        self._spec_hist.append((proposed, accepted))
        if len(self._spec_hist) > self.spec_window:
            self._spec_hist.pop(0)
        if len(self._spec_hist) == self.spec_window:
            tp = sum(p for p, _ in self._spec_hist)
            ta = sum(a for _, a in self._spec_hist)
            if ta < self.spec_accept_floor * tp:
                self._spec_active = False
                self._spec_hist = []
                self.stats.spec_disabled += 1

    def step(self, n_tokens: Optional[int] = None) -> int:
        """Sweep deadlines, stage, run ONE superstep of ``n_tokens``
        (default ``decode_block``) device rounds, drain.  Returns the
        number of requests still in flight (armed + staged + queued)."""
        k = max(1, int(n_tokens)) if n_tokens is not None \
            else self.decode_block
        self._sweep_deadlines()
        if self.faults is not None:
            for s in self.faults.shard_crash(self.stats.decode_steps, k,
                                             self.dp):
                if s not in self.dead_shards:
                    self._crash_shard(s, self.stats.decode_steps)
        self._stage()
        if not any(self.current) and not any(self.staged):
            if self.journal is not None:
                # every step() call is journaled, no-ops included: the
                # replay must re-execute the exact call sequence
                self.journal.record_step({
                    "round": self.stats.decode_steps, "k": k,
                    "noop": True})
                self._maybe_snapshot()
            return len(self.scheduler)
        self._upload_staging()
        if self.faults is not None:
            slots = self.faults.corrupt_state(
                self.stats.decode_steps, k, self.max_batch)
            if slots:
                self._corrupt_slots(slots)
        bsz = self.max_batch

        live = [r for r in self.current + self.staged if r is not None]
        sampled = any(r.temperature > 0 for r in live)
        spec = self.draft is not None and self._spec_active
        chunk_rounds = self._chunk_rounds(k) \
            if self.prompt_chunk > 1 and not spec else None
        names = _COUNTERS + (_SPEC_COUNTERS if spec else ())

        with self.stats.timed("decode"):
            toks, rids, self.state, counters = serve_mesh.make_superstep(
                self.cfg, self.mesh, k, prompt_chunk=self.prompt_chunk,
                draft=self.draft if spec else None)(
                    self.params, self.draft_params, self.state,
                    layers=self.layers, sampled=sampled,
                    chunk_rounds=chunk_rounds)
            # one device-to-host copy for everything the host reads; under
            # a mesh, gathered over the data shards (one row each)
            scal = torch.stack([counters[c] for c in names])
            flat = torch.cat([toks.flatten(), rids.flatten(),
                              counters["nonfinite"].flatten().to(torch.int32),
                              self.state["s_valid"].to(torch.int32),
                              self.state["prompt_pos"], self.state["rid"],
                              scal.to(torch.int32)]).cpu()
            if self.mesh is None:
                gathered = flat.numpy()[None]
            else:
                gathered, mismatches = self.mesh.gather(flat)
                self.tp_plane_mismatches += mismatches
            if self.faults is not None:
                stall = self.faults.straggler(self.stats.decode_calls)
                if stall > 0:
                    time.sleep(stall)
        planes = toks.shape[2] if toks.dim() == 3 else 1
        rps = self._rows_per_shard
        fields = [np.split(row, np.cumsum([rps * k * planes, rps * k * planes,
                                           rps * k, rps, rps, rps]))
                  for row in gathered]
        toks_np, rids_np, nf_np, s_valid_np, pos_np, rid_np = (
            np.concatenate([f[i] for f in fields]) for i in range(6))
        toks_np = toks_np.reshape(bsz, k, planes)
        rids_np = rids_np.reshape(bsz, k, planes)
        nf_np = nf_np.reshape(bsz, k).astype(bool)
        s_valid_np = s_valid_np.astype(bool)
        self._prompt_pos[:] = pos_np
        self._rid_dev[:] = rid_np
        # the counters: one row per data shard, and their sums
        per = [dict(zip(names, (int(v) for v in f[6]))) for f in fields]
        cnt = {c: sum(p[c] for p in per) for c in names}

        base_round = self.stats.decode_steps
        self.stats.decode_calls += 1
        self.stats.decode_steps += k
        self.stats.slot_steps += k * bsz
        self.stats.prefill_tokens += cnt["prefill_steps"]
        self.stats.prefill_rounds += cnt["prefill_rounds"]
        self.stats.wasted_slot_steps += cnt["wasted_slot_steps"]
        self.stats.nonfinite_decode_rounds += cnt["nonfinite_decode_rounds"]
        self.stats.draft_proposed += cnt.get("draft_proposed", 0)
        self.stats.draft_accepted += cnt.get("draft_accepted", 0)
        for sh, p in zip(self.stats.shards, per):
            sh.slot_steps += k * rps
            sh.prefill_rounds += p["prefill_rounds"]
            sh.wasted_slot_steps += p["wasted_slot_steps"]
            sh.nonfinite_decode_rounds += p["nonfinite_decode_rounds"]
        self._adapt_speculation(cnt.get("draft_proposed", 0),
                                cnt.get("draft_accepted", 0))

        now = time.perf_counter()
        dirty = set(self._dirty_slots)
        drained = 0
        drained_shard = [0] * self.dp
        emits: List[List[int]] = []     # (rid, token) in drain order
        for slot in range(bsz):
            sh = self.stats.shards[slot // rps]
            for j in range(k):
                if nf_np[slot, j]:
                    self._quarantine(slot, base_round + j, s_valid_np, dirty)
                for c in range(planes):
                    rid = int(rids_np[slot, j, c])
                    if rid < 0:
                        continue
                    req = self.current[slot]
                    if req is None or req.rid != rid:
                        req = self._promote(slot)   # armed mid-superstep
                        assert req.rid == rid, (req.rid, rid)
                    t = int(toks_np[slot, j, c])
                    if not req.out:
                        req.first_token_s = now
                        req.first_round = base_round + j
                        self.stats.record_first_token(
                            now - req.submitted_s,
                            base_round + j + 1 - req.submit_round)
                        sh.first_tokens += 1
                    req.out.append(t)
                    emits.append([rid, t])
                    drained += 1
                    drained_shard[slot // rps] += 1
                    if (req.eos is not None and t == req.eos) or \
                            len(req.out) >= req.max_new:
                        self._finish(req, now, base_round + j)
            # armed without emitting yet (still prefilling at call end);
            # a slot whose upload was dropped is still parked, not armed
            if self.staged[slot] is not None and not s_valid_np[slot] \
                    and slot not in dirty:
                self._promote(slot)
        # non_spec_tokens: the tokens the non-speculative path would have
        # emitted in these rounds, one per emitting slot-round
        self.stats.decode_tokens += drained
        self.stats.non_spec_tokens += cnt["emit_rounds"] if spec else drained
        for s, (sh, p) in enumerate(zip(self.stats.shards, per)):
            sh.decode_tokens += drained_shard[s]
            sh.non_spec_tokens += p["emit_rounds"] if spec \
                else drained_shard[s]
        # re-sync the staging mirror with what the device consumed --
        # except dirty slots (dropped uploads), whose parked requests the
        # device never saw: their mirror rows stay authoritative
        self._smirror["s_valid"][:] = s_valid_np
        for slot in dirty:
            if self.staged[slot] is not None:
                self._smirror["s_valid"][slot] = True
        if self.journal is not None:
            # after the drain: a crash mid-step replays the whole step
            self.journal.record_step({"round": base_round, "k": k,
                                      "emits": emits,
                                      "digest": self._journal_digest()})
            self._maybe_snapshot()
        return (sum(r is not None for r in self.current)
                + sum(r is not None for r in self.staged)
                + len(self.scheduler))

    def _journal_digest(self) -> Dict[str, int]:
        """Round-clock stats fingerprint written with every step record;
        a replayed step must reproduce it exactly (wall-clock fields are
        absent: they span processes)."""
        st = self.stats
        return {"round": st.decode_steps, "completed": st.completed,
                "cancelled": st.cancelled, "timed_out": st.timed_out,
                "failed": st.failed, "quarantined": st.quarantined,
                "decode_tokens": st.decode_tokens,
                "shard_crashes": st.shard_crashes}

    def _maybe_snapshot(self):
        """Snapshot the serving state every ``snapshot_every`` device
        rounds (not while replaying a journal tail: replay re-executes
        past work, it does not re-persist it)."""
        if self.recover_dir is None or self.journal.replaying:
            return
        if self.stats.decode_steps - self._last_snapshot_round \
                < self.snapshot_every:
            return
        recovery.save_snapshot(self, self.recover_dir,
                               keep=self.snapshot_keep)
        self._last_snapshot_round = self.stats.decode_steps

    # ------------------------------------------------------------------
    def occupancy_report(self) -> Dict[str, Any]:
        slots = []
        for i in range(self.max_batch):
            cur, parked = self.current[i], self.staged[i]
            slots.append({
                "slot": i,
                "current": None if cur is None else {
                    "rid": cur.rid, "status": cur.status,
                    "prompt_len": len(cur.prompt),
                    "prompt_pos": int(self._prompt_pos[i]),
                    "out_tokens": len(cur.out),
                    "deadline": cur.deadline, "retries": cur.retries},
                "staged": None if parked is None else {
                    "rid": parked.rid, "status": parked.status,
                    "not_before": parked.not_before}})
        return {"decode_steps": self.stats.decode_steps,
                "queue_depth": len(self.scheduler),
                "queued": [r.rid for r in self.scheduler.waiting],
                "in_flight": sum(r is not None for r in self.current),
                "staged": sum(r is not None for r in self.staged),
                "dead_shards": sorted(self.dead_shards),
                "slots": slots}

    def run_to_completion(self, max_steps: int = 100_000
                          ) -> Dict[int, List[int]]:
        """Step until every request is terminal; ``{rid: tokens}``."""
        steps = 0
        while (len(self.scheduler) or any(self.current)
               or any(self.staged)):
            if steps >= max_steps:
                report = self.occupancy_report()
                raise EngineStallError(
                    f"engine did not drain within {max_steps} steps: "
                    f"{report['queue_depth']} queued, "
                    f"{report['in_flight']} in flight, "
                    f"{report['staged']} staged at round "
                    f"{report['decode_steps']} (see .report)", report)
            self.step()
            steps += 1
        return {rid: r.out for rid, r in self.finished.items()}


def replay_trace(engine: ServingEngine, trace: List[Dict[str, Any]],
                 submit, max_steps: int = 100_000, start: int = 0,
                 stop=None) -> int:
    """Drive ``engine`` over an arrival trace until every request is
    terminal.  The arrival clock is the engine's device-round counter:
    request ``i`` is submitted via ``submit(i, trace[i])`` once
    ``trace[i]["arrival"] <= stats.decode_steps`` -- or at once when the
    engine is idle, so a gap in arrivals cannot stall the round clock.
    Drain is judged on *terminal* requests (``engine.finished``), so
    shed / failed / timed-out requests cannot hang the replay.

    Crash-recovery hooks: ``start`` says how many leading trace entries
    were already submitted (continue a restored engine with
    ``start=len(engine.requests)``), and ``stop(engine)`` is checked
    after every step -- True abandons the drive mid-trace.  Returns how
    many trace entries have been submitted.  Submission is driven by the
    round clock and terminal counts only, so a continued drive makes the
    same submit-round decisions an uninterrupted one would."""
    i, steps = start, 0
    while i < len(trace) or len(engine.finished) < i:
        due = i < len(trace) and \
            trace[i]["arrival"] <= engine.stats.decode_steps
        idle = len(engine.finished) == i
        while i < len(trace) and (due or idle):
            submit(i, trace[i])
            i += 1
            due = i < len(trace) and \
                trace[i]["arrival"] <= engine.stats.decode_steps
            idle = False
        engine.step()
        steps += 1
        if stop is not None and stop(engine):
            return i
        if steps >= max_steps:
            raise RuntimeError(
                f"arrival trace did not drain within {max_steps} steps "
                f"({len(engine.finished)}/{i} submitted requests "
                f"terminal)")
    return i


def generate_one(cfg, params, prompt: List[int], max_new: int = 32,
                 max_len: int = 2048, device="cuda") -> List[int]:
    """Single-request greedy reference path (the engine parity oracle):
    the prompt goes token by token through ``lm.decode_step``, the same
    path the superstep uses."""
    if not prompt:
        raise ValueError("empty prompt")
    if len(prompt) + max_new - 1 > max_len:
        raise ValueError(
            f"prompt ({len(prompt)}) + max_new ({max_new}) needs "
            f"{len(prompt) + max_new - 1} cache positions, exceeding "
            f"max_len ({max_len})")
    dev = resolve_device(device)
    params = lm.tree_to(params, dev)
    layers = lm.bind_layers(params, cfg)
    cache = lm.init_cache(cfg, 1, max_len, dev)
    logits = None
    for t in prompt:
        logits, cache = lm.decode_step(
            params, cfg, torch.tensor([t], dtype=torch.int32, device=dev),
            cache, layers=layers)
    out = [int(logits[0, :cfg.vocab_size].argmax())]
    for _ in range(max_new - 1):
        logits, cache = lm.decode_step(
            params, cfg,
            torch.tensor([out[-1]], dtype=torch.int32, device=dev), cache,
            layers=layers)
        out.append(int(logits[0, :cfg.vocab_size].argmax()))
    return out
