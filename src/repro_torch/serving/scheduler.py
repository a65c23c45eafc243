"""Admission scheduling + engine statistics for the serving engine.

A copy of ``repro.serving.scheduler`` (the port imports nothing from the
JAX package).  The policy and the accounting live *outside* the engine's
device plumbing, so policy experiments (priority queues, deadline shaping, length-aware
packing) don't touch device code.

``AdmissionScheduler`` owns three serving-robustness policies:

  * **admission verdicts** -- ``submit()`` returns :data:`ADMITTED`,
    :data:`REJECTED_QUEUE_FULL` (bounded queue, high/low watermark
    hysteresis) or :data:`SHED_UNMEETABLE_DEADLINE` (the caller passes a
    capacity estimate -- the engine builds it from its ``_row_eta``
    rounds-to-free machinery -- and a request whose deadline cannot be
    met even by the estimate is shed at the door instead of wasting a
    slot);
  * **priority classes + EDF ordering with aging** -- ``take()`` pops by
    ``(effective priority, deadline, submission order)`` where a
    request's effective priority improves by one class for every
    ``aging_rounds`` device rounds it has waited, so low-priority work
    cannot starve behind a stream of high-priority arrivals;
  * **retry backoff** -- requests carry ``not_before`` (a device round);
    ``take`` skips them until the round clock catches up, which is how
    the engine's NaN-quarantine retry backoff is enforced.  When the
    engine is otherwise idle it takes with ``ignore_backoff=True`` --
    backoff exists to let a transient fault clear while other work runs,
    not to stall an empty machine.

With the default config (unbounded queue, one priority class, no
deadlines) the behaviour is exactly the original strict FIFO: ``take``
pops in submission order and every request is eventually popped
(``tests/test_scheduler.py`` property-tests both against random arrival
traces).  ``FifoScheduler`` remains as an alias for that degenerate
configuration.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# Admission verdicts (returned by AdmissionScheduler.submit)
# ---------------------------------------------------------------------------
ADMITTED = "ADMITTED"
REJECTED_QUEUE_FULL = "REJECTED_QUEUE_FULL"
SHED_UNMEETABLE_DEADLINE = "SHED_UNMEETABLE_DEADLINE"


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8
    # bounded queue: 0 = unbounded (legacy behaviour).  Admission closes
    # when the queue reaches ceil(high_watermark * max_queue) and stays
    # closed (hysteresis) until it drains below low_watermark * max_queue,
    # so a saturated engine sheds bursts instead of oscillating.
    max_queue: int = 0
    high_watermark: float = 1.0
    low_watermark: float = 0.5
    # EDF aging: waiting this many device rounds improves a request's
    # effective priority by one class (0 disables aging).
    aging_rounds: int = 64


class AdmissionScheduler:
    """Priority + deadline (EDF with aging) admission with a bounded queue.

    Requests are engine-owned objects; the scheduler reads (with safe
    defaults, so plain tagged objects work in tests) ``priority`` (lower
    is more urgent), ``deadline`` (absolute device round or None),
    ``submit_round`` and ``not_before``.
    """

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.waiting: List = []           # Request objects (engine-owned)
        self._seq = 0
        self._order: Dict[int, int] = {}  # id(req) -> submission seq
        self._saturated = False

    # -- admission ----------------------------------------------------
    def submit(self, req, now_round: int = 0,
               est_finish: Optional[int] = None) -> str:
        """Admit ``req`` or return a rejection verdict.

        ``est_finish`` is the caller's capacity estimate (absolute device
        round by which the request could plausibly finish); when the
        request carries a deadline the estimate cannot meet, it is shed
        immediately rather than admitted to die in the queue.
        """
        if self.cfg.max_queue > 0:
            hi = math.ceil(self.cfg.high_watermark * self.cfg.max_queue)
            lo = self.cfg.low_watermark * self.cfg.max_queue
            if self._saturated and len(self.waiting) < lo:
                self._saturated = False
            if len(self.waiting) >= min(hi, self.cfg.max_queue):
                self._saturated = True
            if self._saturated:
                return REJECTED_QUEUE_FULL
        deadline = getattr(req, "deadline", None)
        if deadline is not None and est_finish is not None \
                and est_finish > deadline:
            return SHED_UNMEETABLE_DEADLINE
        self._order[id(req)] = self._seq
        self._seq += 1
        self.waiting.append(req)
        return ADMITTED

    def remove(self, req) -> bool:
        """Withdraw a queued request (cancellation / deadline sweep)."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return False
        self._order.pop(id(req), None)
        return True

    def __len__(self) -> int:
        return len(self.waiting)

    # -- ordering -----------------------------------------------------
    def _key(self, req, now_round: int):
        pr = getattr(req, "priority", 1)
        if self.cfg.aging_rounds > 0:
            waited = max(0, now_round - getattr(req, "submit_round", 0))
            pr = pr - waited // self.cfg.aging_rounds
        deadline = getattr(req, "deadline", None)
        return (pr, math.inf if deadline is None else deadline,
                self._order[id(req)])

    def take(self, n: int, now_round: int = 0,
             ignore_backoff: bool = False) -> List:
        """Pop the next admission group of up to ``n`` requests by
        (aged priority, earliest deadline, submission order).  Within one
        priority class with no deadlines this is exact submission order:
        aging can only *improve* an earlier request's class relative to a
        later one, never degrade it, so default-config behaviour is
        strict FIFO.  Requests whose ``not_before`` round is still in the
        future are skipped unless ``ignore_backoff``.
        """
        n = max(0, n)
        pool = self.waiting if ignore_backoff else \
            [r for r in self.waiting
             if getattr(r, "not_before", 0) <= now_round]
        group = sorted(pool, key=lambda r: self._key(r, now_round))[:n]
        for req in group:
            self.waiting.remove(req)
            self._order.pop(id(req), None)
        return group

    # -- snapshot support (serving/recovery.py) -----------------------
    def state_dict(self) -> dict:
        """JSON-able queue state: waiting requests as ``[rid, seq]``
        pairs in queue order plus the submission-sequence counter and
        the saturation latch.  Requests themselves are engine-owned and
        serialized by the engine snapshot; this captures only what the
        scheduler adds on top (ordering + hysteresis)."""
        return {"waiting": [[r.rid, self._order[id(r)]]
                            for r in self.waiting],
                "seq": self._seq, "saturated": self._saturated}

    def load_state_dict(self, state: dict, requests) -> None:
        """Rebuild the queue from :meth:`state_dict` output;
        ``requests`` maps rid -> the restored Request object."""
        self.waiting = [requests[rid] for rid, _ in state["waiting"]]
        self._order = {id(requests[rid]): int(seq)
                       for rid, seq in state["waiting"]}
        self._seq = int(state["seq"])
        self._saturated = bool(state["saturated"])


# Degenerate configuration of AdmissionScheduler (unbounded queue, one
# priority class, no deadlines) == the original strict-FIFO scheduler.
FifoScheduler = AdmissionScheduler


@dataclasses.dataclass
class ShardStats:
    """One data shard's slice of the slot-step identity.

    Under a ``--mesh dxm`` serving mesh the slot pool splits into ``d``
    contiguous row groups (shard ``s`` owns rows ``[s*B/d, (s+1)*B/d)``)
    and the superstep emits its counters per shard, so the identity
    ``slot_steps == prefill_rounds + non_spec_tokens - first_tokens +
    wasted_slot_steps + nonfinite_decode_rounds`` must hold for every
    shard individually as well as summed (the single-device engine is
    the ``d=1`` special case with one shard).  ``non_spec_tokens`` equals
    ``decode_tokens`` without speculation; ``first_tokens`` counts
    requests whose first output token this shard emitted (each rides its
    final prefill round -- the overlap term)."""
    slot_steps: int = 0
    prefill_rounds: int = 0
    decode_tokens: int = 0
    first_tokens: int = 0
    wasted_slot_steps: int = 0
    nonfinite_decode_rounds: int = 0
    non_spec_tokens: int = 0

    def identity_ok(self) -> bool:
        return self.slot_steps == (
            self.prefill_rounds + self.non_spec_tokens - self.first_tokens
            + self.wasted_slot_steps + self.nonfinite_decode_rounds)


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, int(q * (len(ys) - 1) + 0.5))
    return float(ys[i])


@dataclasses.dataclass
class EngineStats:
    """Counters + wall-clock for the serving superstep loop.

    ``decode_steps`` counts *device* rounds (K per superstep) while
    ``decode_calls`` counts host round-trips (one ``lm.superstep``
    dispatch each); ``slot_steps`` is rounds x batch -- every row is
    stepped every round to keep shapes static, and ``wasted_slot_steps``
    counts the rows that were stepped while dead with nothing staged
    (the idle waste in-loop re-admission exists to eliminate;
    ``snapshot()['wasted_slot_fraction']`` is the trajectory metric).
    ``prefill_tokens`` counts prompt tokens consumed on device (up to
    ``prompt_chunk`` per prefilling row-round under packed prefill) and
    ``prefill_rounds`` the slot-rounds spent prefilling (== tokens at
    C=1); the exact slot-step identity under any C is ``slot_steps ==
    prefill_rounds + decode_tokens - first_token_overlaps +
    wasted_slot_steps + nonfinite_decode_rounds`` (a request's first
    token rides its final prefill round; a round whose emission the
    non-finite guard suppressed is counted by the last term -- see
    below).  Timers wrap the device calls including host sync, so
    tokens-per-second is an end-to-end number.

    Per-request latency: ``ttft_s`` / ``ttft_rounds`` measure submit ->
    first token (wall clock at host drain granularity, and exact device
    rounds); ``itl_s`` is the per-request mean inter-token gap in wall
    seconds (host drain granularity -- the load signal), while
    ``itl_rounds`` is the same gap in device rounds.  The superstep
    never stalls an emitting row, so without speculation ``itl_rounds``
    is 1.0 by construction; it is kept as a regression canary -- any
    deviation above 1.0 means a scheduler/preemption change started
    inserting idle rounds into running streams, while values below 1.0
    are exactly the speculative multi-emit win.

    Speculative decoding: ``draft_proposed`` / ``draft_accepted`` count
    draft tokens offered to / accepted by the verifier, and
    ``non_spec_tokens`` counts the tokens the non-speculative path
    contributes (one per emitting slot-round -- the verify round's own
    token).  The exact identities: ``decode_tokens == draft_accepted +
    non_spec_tokens``, and the slot-step identity above holds with
    ``decode_tokens`` replaced by ``non_spec_tokens`` (a spec round is
    still ONE slot-step however many tokens it emits).
    ``snapshot()['accept_rate']`` is the trajectory metric.
    ``spec_disabled`` counts the times the rolling accept-rate floor
    turned drafting off (graceful degradation under hostile inputs).

    Fault tolerance: ``cancelled`` / ``timed_out`` / ``failed`` /
    ``shed`` / ``rejected`` count terminal request outcomes other than
    completion (shed = unmeetable deadline at admission, rejected =
    bounded-queue backpressure); ``retried`` counts quarantine re-
    enqueues and ``quarantined`` counts slot kills by the non-finite
    guard.  ``nonfinite_decode_rounds`` is the guard's slot-step
    identity term: a round whose emission was suppressed on a decoding
    row appears in no other counter.  Terminal accounting: ``submitted
    == completed + cancelled + timed_out + failed + shed + rejected``
    once the engine drains (retries move a request back to the queue,
    they are not terminal).

    DP-shard failover: ``shard_crashes`` counts data shards the
    ``shard_crash`` chaos point killed and ``failover_requeued`` the
    staged/in-flight requests drained off dead shards back onto the
    survivors (a failover requeue restarts the stream like a quarantine
    retry but burns no retry budget -- the crash is not the request's
    fault).  A dead shard's rows keep stepping as ``wasted_slot_steps``
    on its own :class:`ShardStats`, so the per-shard identity holds
    through a crash.
    """
    prompt_chunk: int = 1
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    prefill_tokens: int = 0
    prefill_rounds: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    decode_calls: int = 0
    slot_steps: int = 0
    wasted_slot_steps: int = 0
    draft_proposed: int = 0
    draft_accepted: int = 0
    non_spec_tokens: int = 0
    queue_peak: int = 0
    # fault-tolerance counters
    cancelled: int = 0
    timed_out: int = 0
    failed: int = 0
    retried: int = 0
    shed: int = 0
    rejected: int = 0
    quarantined: int = 0
    nonfinite_decode_rounds: int = 0
    spec_disabled: int = 0
    # DP-shard failover (serving/recovery.py + faults.shard_crash)
    shard_crashes: int = 0
    failover_requeued: int = 0
    decode_time_s: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    ttft_rounds: List[int] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)
    itl_rounds: List[float] = dataclasses.field(default_factory=list)
    # per-data-shard identity slices (one entry on a single-device mesh);
    # the engine initialises this to its mesh's data-axis size
    shards: List[ShardStats] = dataclasses.field(default_factory=list)

    def shard_identities_ok(self) -> bool:
        """Slot-step identity per shard AND for the cross-shard sums."""
        if not all(s.identity_ok() for s in self.shards):
            return False
        tot = ShardStats()
        for s in self.shards:
            for f in dataclasses.fields(ShardStats):
                setattr(tot, f.name,
                        getattr(tot, f.name) + getattr(s, f.name))
        return tot.identity_ok()

    def observe_queue(self, depth: int) -> None:
        self.queue_peak = max(self.queue_peak, depth)

    def record_first_token(self, wall_s: float, rounds: int) -> None:
        self.ttft_s.append(wall_s)
        self.ttft_rounds.append(rounds)

    def record_completion(self, n_tokens: int, first_round: int,
                          last_round: int, first_s: float = 0.0,
                          last_s: float = 0.0) -> None:
        if n_tokens > 1:
            self.itl_rounds.append(
                (last_round - first_round) / (n_tokens - 1))
            self.itl_s.append((last_s - first_s) / (n_tokens - 1))

    def timed(self, kind: str):
        """Context manager: adds elapsed wall time to ``<kind>_time_s``."""
        stats = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                setattr(stats, f"{kind}_time_s",
                        getattr(stats, f"{kind}_time_s") + dt)
                return False

        return _Timer()

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    def tokens_per_second(self) -> float:
        return self.total_tokens / max(self.decode_time_s, 1e-9)

    def decode_tokens_per_second(self) -> float:
        return self.decode_tokens / max(self.decode_time_s, 1e-9)

    def snapshot(self) -> Dict[str, float]:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)
             if not isinstance(getattr(self, f.name), list)}
        d["tokens_per_second"] = self.tokens_per_second()
        d["decode_tokens_per_second"] = self.decode_tokens_per_second()
        d["host_roundtrips_per_decode_token"] = (
            self.decode_calls / max(self.decode_tokens, 1))
        d["wasted_slot_fraction"] = (
            self.wasted_slot_steps / max(self.slot_steps, 1))
        d["accept_rate"] = (
            self.draft_accepted / max(self.draft_proposed, 1))
        d["completion_rate"] = self.completed / max(self.submitted, 1)
        d["ttft_s_mean"] = (sum(self.ttft_s) / len(self.ttft_s)
                            if self.ttft_s else 0.0)
        d["ttft_s_p95"] = _percentile(self.ttft_s, 0.95)
        d["ttft_rounds_mean"] = (
            sum(self.ttft_rounds) / len(self.ttft_rounds)
            if self.ttft_rounds else 0.0)
        d["itl_s_mean"] = (sum(self.itl_s) / len(self.itl_s)
                           if self.itl_s else 0.0)
        d["itl_rounds_mean"] = (sum(self.itl_rounds) / len(self.itl_rounds)
                                if self.itl_rounds else 0.0)
        if self.shards:
            d["n_shards"] = len(self.shards)
            d["shards"] = [dataclasses.asdict(s) for s in self.shards]
            d["shard_identities_ok"] = self.shard_identities_ok()
        return d
