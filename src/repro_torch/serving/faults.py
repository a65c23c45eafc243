"""Deterministic fault injection for the serving engine (chaos harness).

A copy of ``repro.serving.faults`` (numpy only; the port imports nothing
from the JAX package): with the same :class:`FaultConfig` and the same
call sequence it draws the same schedule, event for event.

Every fault path the engine's robustness layer handles -- non-finite
activations, lost staging uploads, straggling device rounds -- can be
*expressed* here and replayed exactly, so failure handling is tested the
same way correctness is: against a seeded, reproducible schedule rather
than by waiting for production to break.

``FaultInjector`` is consulted by ``ServingEngine.step`` at three named
injection points:

  * ``corrupt_state`` -- before the superstep dispatch covering device
    rounds ``[base_round, base_round + k)``, returns the slots whose
    recurrent state the engine overwrites with NaN.  The in-loop
    numerical health guard then detects the poisoned row on its next
    round, suppresses its emission and kills it (quarantine -> bounded
    retry).  Explicit ``nan_at=((round, slot), ...)`` schedules fire at
    the superstep boundary covering that round (host code cannot reach
    inside the superstep mid-flight -- with ``decode_block=1`` the
    boundary IS the round); ``nan_rate`` draws per slot-round.
  * ``drop_upload`` -- a staged-request upload "fails": the engine skips
    those slots' staging upload this host round-trip and retries on the
    next, so the request arms one superstep late.  Models a transient
    host->device transfer loss without losing the request.
  * ``straggler`` -- after the superstep returns, the engine stalls for
    ``straggler_s`` wall seconds, modelling a slow device round (shows
    up in wall-clock latency stats, never in round-clock counters).
  * ``shard_crash`` -- before staging, kills a whole data shard of the
    slot pool at a scheduled device round (``shard_crash_at``): the
    engine marks the shard's rows permanently dead, drains its staged +
    in-flight requests back through the requeue path onto the surviving
    shards and serves degraded on the smaller pool (DP-shard failover;
    see README "Failure model" / "Crash recovery").

Determinism: each injection point owns an independent
``numpy.random.Generator`` seeded from ``seed``, and every call draws a
fixed-shape sample, so a fixed engine configuration + request trace
replays the exact same fault schedule.  An engine constructed with
``faults=None`` never touches this module (the injector is fully inert
when disabled -- the fault-free path is bit-identical with or without
the harness importable), and an injector with all rates zero and no
explicit schedules injects nothing.

``injector.events`` logs every injected fault as ``(kind, when, slot)``
tuples for assertions and bench reporting.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

INJECTION_POINTS = ("corrupt_state", "drop_upload", "straggler",
                    "shard_crash")

_RATE_FIELDS = ("nan_rate", "drop_rate", "straggler_rate")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault schedule for :class:`FaultInjector`.

    Rates are per-opportunity probabilities: ``nan_rate`` per slot-round,
    ``drop_rate`` per dirty staging slot per upload, ``straggler_rate``
    per host round-trip.  ``nan_at`` adds explicit (device round, slot)
    corruptions on top of the random draws (the deterministic handle the
    unit tests use).  ``shard_crash_at`` is an explicit (device round,
    data shard) kill schedule: the engine drains the dead shard's
    requests onto the survivors and serves degraded (DP-shard failover
    -- a crash is a scheduled event, not a rate, so recovery replays are
    exact).  Rates outside [0, 1] are rejected at construction: a typo'd
    ``nan_rate=10`` would otherwise silently behave as rate 1.0.
    """
    seed: int = 0
    nan_rate: float = 0.0
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_s: float = 0.001
    nan_at: Tuple[Tuple[int, int], ...] = ()
    shard_crash_at: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        for name in _RATE_FIELDS:
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(
                    f"{name} is a probability and must be in [0, 1], "
                    f"got {v!r}")
        if self.straggler_s < 0.0:
            raise ValueError(
                f"straggler_s must be >= 0 seconds, got "
                f"{self.straggler_s!r}")


class FaultInjector:
    def __init__(self, cfg: FaultConfig = None, **kw):
        if cfg is None:
            cfg = FaultConfig(**kw)
        elif kw:
            raise ValueError("pass FaultConfig or kwargs, not both")
        self.cfg = cfg
        self._rng = {p: np.random.default_rng(cfg.seed * 7919 + i)
                     for i, p in enumerate(INJECTION_POINTS)}
        self.events: List[Tuple[str, int, int]] = []
        self._crashed_shards: set = set()

    # -- named injection points ---------------------------------------
    def corrupt_state(self, base_round: int, k: int,
                      batch: int) -> List[int]:
        """Slots to poison before the superstep over rounds
        ``[base_round, base_round + k)``."""
        hits = {slot for r, slot in self.cfg.nan_at
                if base_round <= r < base_round + k and 0 <= slot < batch}
        if self.cfg.nan_rate > 0.0:
            draws = self._rng["corrupt_state"].random((k, batch))
            hits |= set(np.nonzero((draws < self.cfg.nan_rate)
                                   .any(axis=0))[0].tolist())
        slots = sorted(hits)
        self.events.extend(("corrupt_state", base_round, s) for s in slots)
        return slots

    def drop_upload(self, call_idx: int,
                    slots: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Split this upload's dirty slots into (kept, dropped)."""
        if self.cfg.drop_rate <= 0.0 or not slots:
            return list(slots), []
        draws = self._rng["drop_upload"].random(len(slots))
        kept = [s for s, d in zip(slots, draws)
                if d >= self.cfg.drop_rate]
        dropped = [s for s in slots if s not in kept]
        self.events.extend(("drop_upload", call_idx, s) for s in dropped)
        return kept, dropped

    def straggler(self, call_idx: int) -> float:
        """Seconds of injected stall after this host round-trip."""
        if self.cfg.straggler_rate <= 0.0:
            return 0.0
        if self._rng["straggler"].random() < self.cfg.straggler_rate:
            self.events.append(("straggler", call_idx, -1))
            return self.cfg.straggler_s
        return 0.0

    def shard_crash(self, base_round: int, k: int,
                    n_shards: int) -> List[int]:
        """Data shards scheduled to die during the superstep covering
        rounds ``[base_round, base_round + k)`` (each shard fires at
        most once per injector lifetime -- a dead shard stays dead).
        Schedule-only by design: a crash is the one fault whose recovery
        path must replay exactly, so it is pinned to a device round
        rather than drawn from a rate."""
        hits = {shard for r, shard in self.cfg.shard_crash_at
                if base_round <= r < base_round + k
                and 0 <= shard < n_shards} - self._crashed_shards
        shards = sorted(hits)
        self._crashed_shards |= hits
        self.events.extend(("shard_crash", base_round, s) for s in shards)
        return shards

    # -- reporting ----------------------------------------------------
    def counts(self) -> dict:
        """Injected-event count per injection point (every point keyed,
        including zero-count ones, so dashboards diff cleanly)."""
        out = {p: 0 for p in INJECTION_POINTS}
        for kind, _, _ in self.events:
            out[kind] += 1
        return out

    # -- snapshot support (serving/recovery.py) -----------------------
    def state_dict(self) -> dict:
        """JSON-able mid-trace state: per-point RNG generator states,
        the event log and the fired shard-crash set.  Restoring this
        into a fresh injector (same :class:`FaultConfig`) makes the
        remaining fault schedule identical to the uninterrupted run --
        the property journal-tail replay needs."""
        return {
            "rng": {p: g.bit_generator.state
                    for p, g in self._rng.items()},
            "events": [list(e) for e in self.events],
            "crashed_shards": sorted(self._crashed_shards),
        }

    def load_state_dict(self, state: dict) -> None:
        for p, s in state.get("rng", {}).items():
            if p in self._rng:
                self._rng[p].bit_generator.state = s
        self.events = [tuple(e) for e in state.get("events", [])]
        self._crashed_shards = set(state.get("crashed_shards", []))
