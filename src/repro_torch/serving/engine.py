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

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP.md entry): serving meshes, fault injection, crash recovery
(``recover_dir`` / ``restore``) and autotune plans.
``fuse_block="off"`` serves on the cell-only kernel tier; the attention
trunk with a minRNN mixer (gemma-2b-mingru) always does.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import draft as draft_lib
from repro_torch.serving import sampling
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
    """``run_to_completion`` exceeded ``max_steps`` with work pending."""

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


def _not_ported(what: str, entry: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet (ROADMAP.md "
        f"{entry})")


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
                 recover_dir: Optional[str] = None):
        if mesh is not None:
            _not_ported("mesh-sharded serving", "queue 1, item 6")
        if faults is not None:
            _not_ported("fault injection", "queue 1, item 3")
        if recover_dir is not None:
            _not_ported("crash recovery", "queue 1, item 3")
        if tune is not None:
            _not_ported("autotune plans", "queue 1, item 3")
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
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = lm.tree_to(params, self.device)
        # the engine owns the params for its lifetime: bind them for the
        # kernels once, not once per round
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
        self.state = lm.init_slot_state(cfg, max_batch, max_len, seed=seed,
                                        draft=self.draft, device=self.device)
        self.scheduler = AdmissionScheduler(SchedulerConfig(
            max_batch=max_batch, max_queue=max_queue,
            high_watermark=high_watermark, low_watermark=low_watermark,
            aging_rounds=aging_rounds))
        self.stats = EngineStats(prompt_chunk=self.prompt_chunk,
                                 shards=[ShardStats()])
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff = max(0, int(retry_backoff))
        self._next_rid = 0
        self.current: List[Optional[Request]] = [None] * max_batch
        self.staged: List[Optional[Request]] = [None] * max_batch
        self.finished: Dict[int, Request] = {}
        self.requests: Dict[int, Request] = {}
        # host mirrors of the staging tensors (authoritative on the host;
        # the device only consumes them, flipping s_valid)
        self._smirror = {k: self.state[k].cpu().numpy().copy()
                         for k in _STAGE_FIELDS}
        self._dirty_slots: List[int] = []
        self._prompt_pos = np.zeros((max_batch,), np.int32)
        self._rid_dev = np.full((max_batch,), -1, np.int32)

    # ------------------------------------------------------------------
    @property
    def kernel_tier(self) -> str:
        """"block-fused" (one whole-block kernel launch per layer per
        round), "cell-fused" (one cell-only kernel launch per layer per
        round) or "unfused" (plain PyTorch)."""
        return lm.kernel_tier(self.cfg)

    @classmethod
    def restore(cls, *args, **kwargs):
        _not_ported("crash recovery (ServingEngine.restore)",
                    "queue 1, item 3")

    def _service_rounds(self, req: Request) -> int:
        """Rounds a request holds a row: packed prefill plus decode, less
        the round where both meet.  Under speculation an upper bound (a
        round commits at least one token)."""
        return -(-len(req.prompt) // self.prompt_chunk) + req.max_new - 1

    def _est_finish_round(self, req: Request) -> int:
        """The device round by which ``req`` could finish, the work ahead
        of it placed on the soonest-freeing rows; an upper bound under
        speculation, used only to shed deadlines it cannot meet."""
        etas = [self._row_eta(s) for s in range(self.max_batch)]
        for i in range(self.max_batch):
            if self.staged[i] is not None:
                etas[i] += self._service_rounds(self.staged[i])
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
        order, soonest-freeing rows first."""
        empty = [i for i in range(self.max_batch) if self.staged[i] is None]
        now = self.stats.decode_steps
        group = self.scheduler.take(len(empty), now_round=now)
        if not group and self.scheduler.waiting \
                and not any(self.current) and not any(self.staged):
            group = self.scheduler.take(len(empty), now_round=now,
                                        ignore_backoff=True)
        m = self._smirror
        for req in group:
            empty.sort(key=lambda i: (self._row_eta(i), i))
            slot = empty.pop(0)
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
        the (B, max_len) prompt matrix only for the dirty rows."""
        if not self._dirty_slots:
            return
        rows = sorted(set(self._dirty_slots))
        idx = torch.as_tensor(rows, device=self.device)
        self.state["s_prompt"][idx] = torch.as_tensor(
            self._smirror["s_prompt"][rows]).to(self.device)
        for k in _STAGE_FIELDS:
            if k != "s_prompt":
                self.state[k] = torch.as_tensor(self._smirror[k]).to(
                    self.device)
        self._dirty_slots = []

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
        self.state["alive"] = self.state["alive"].clone()
        self.state["alive"][req.slot] = False
        self._retire(req, status)

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

    def _quarantine(self, slot: int, round_: int, s_valid_np, dirty):
        """The non-finite guard killed this row: re-enqueue its request
        under the retry budget (exponential backoff) or retire it FAILED."""
        self.stats.quarantined += 1
        req = self.current[slot]
        if req is None or req.done:
            if self.staged[slot] is not None and not s_valid_np[slot] \
                    and slot not in dirty:
                req = self._promote(slot)
            else:
                return
        self.current[slot] = None
        req.slot = None
        if req.deadline is not None and round_ >= req.deadline:
            self._retire(req, TIMED_OUT)
            return
        if req.retries >= self.max_retries:
            self._retire(req, FAILED)
            return
        req.verdict = self.scheduler.submit(req, now_round=round_)
        if req.verdict != ADMITTED:
            self._retire(req, FAILED)
            return
        req.retries += 1
        self.stats.retried += 1
        req.out = []
        req.status = QUEUED
        req.not_before = round_ + self.retry_backoff * (2 ** (req.retries - 1))
        self.stats.observe_queue(len(self.scheduler))

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
        self._stage()
        if not any(self.current) and not any(self.staged):
            return len(self.scheduler)
        self._upload_staging()
        bsz = self.max_batch

        live = [r for r in self.current + self.staged if r is not None]
        sampled = any(r.temperature > 0 for r in live)
        spec = self.draft is not None and self._spec_active
        chunk_rounds = self._chunk_rounds(k) \
            if self.prompt_chunk > 1 and not spec else None
        names = _COUNTERS + (_SPEC_COUNTERS if spec else ())

        with self.stats.timed("decode"):
            toks, rids, self.state, counters = lm.superstep(
                self.params, self.cfg, self.state, k,
                prompt_chunk=self.prompt_chunk, layers=self.layers,
                sampled=sampled, chunk_rounds=chunk_rounds,
                draft=self.draft if spec else None,
                draft_params=self.draft_params)
            # one device-to-host copy for everything the host reads
            scal = torch.stack([counters[c] for c in names])
            flat = torch.cat([toks.flatten(), rids.flatten(),
                              counters["nonfinite"].flatten().to(torch.int32),
                              self.state["s_valid"].to(torch.int32),
                              self.state["prompt_pos"], self.state["rid"],
                              scal.to(torch.int32)]).cpu().numpy()
        planes = toks.shape[2] if toks.dim() == 3 else 1
        toks_np, rids_np, nf_np, s_valid_np, pos_np, rid_np, scal_np = \
            np.split(flat, np.cumsum([bsz * k * planes, bsz * k * planes,
                                      bsz * k, bsz, bsz, bsz]))
        toks_np = toks_np.reshape(bsz, k, planes)
        rids_np = rids_np.reshape(bsz, k, planes)
        nf_np = nf_np.reshape(bsz, k).astype(bool)
        s_valid_np = s_valid_np.astype(bool)
        self._prompt_pos[:] = pos_np
        self._rid_dev[:] = rid_np
        cnt = dict(zip(names, (int(v) for v in scal_np)))

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
        sh = self.stats.shards[0]
        sh.slot_steps += k * bsz
        sh.prefill_rounds += cnt["prefill_rounds"]
        sh.wasted_slot_steps += cnt["wasted_slot_steps"]
        sh.nonfinite_decode_rounds += cnt["nonfinite_decode_rounds"]
        self._adapt_speculation(cnt.get("draft_proposed", 0),
                                cnt.get("draft_accepted", 0))

        now = time.perf_counter()
        dirty = set(self._dirty_slots)
        drained = 0
        for slot in range(bsz):
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
                    drained += 1
                    if (req.eos is not None and t == req.eos) or \
                            len(req.out) >= req.max_new:
                        self._finish(req, now, base_round + j)
            # armed without emitting yet (still prefilling at call end)
            if self.staged[slot] is not None and not s_valid_np[slot] \
                    and slot not in dirty:
                self._promote(slot)
        # non_spec_tokens: the tokens the non-speculative path would have
        # emitted in these rounds, one per emitting slot-round
        non_spec = cnt["emit_rounds"] if spec else drained
        self.stats.decode_tokens += drained
        self.stats.non_spec_tokens += non_spec
        sh.decode_tokens += drained
        sh.non_spec_tokens += non_spec
        self._smirror["s_valid"][:] = s_valid_np
        return (sum(r is not None for r in self.current)
                + sum(r is not None for r in self.staged)
                + len(self.scheduler))

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
                    "out_tokens": len(cur.out)},
                "staged": None if parked is None else {
                    "rid": parked.rid, "status": parked.status}})
        return {"decode_steps": self.stats.decode_steps,
                "queue_depth": len(self.scheduler),
                "queued": [r.rid for r in self.scheduler.waiting],
                "in_flight": sum(r is not None for r in self.current),
                "staged": sum(r is not None for r in self.staged),
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
                    f"engine did not drain within {max_steps} steps "
                    f"(see .report)", report)
            self.step()
            steps += 1
        return {rid: r.out for rid, r in self.finished.items()}


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
