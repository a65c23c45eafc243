"""Fault-tolerant training supervision (``repro.training.fault_tolerance``,
copied: the port imports nothing of the reference package).

``TrainSupervisor`` wraps the step loop with:

  * crash recovery: any exception in a step triggers restore from the last
    checkpoint and a deterministic data fast-forward (the data pipeline is
    a pure function of step index -- repro_torch.data: no iterator state
    to lose).
    Restore verifies the checkpoint's content checksum and falls back past
    corrupt ones (``SupervisorReport.ckpt_fallbacks`` counts them);
  * straggler watchdog: per-step wall time EMA; steps slower than
    ``straggler_factor`` x EMA are logged and counted (on a real cluster
    the hook re-dispatches the shard -- here it records the event);
  * bounded retries so a deterministically-failing step surfaces instead of
    looping forever.

At 1000+ nodes the same structure holds: each host runs this loop over its
own shard; checkpoint save/restore is collective-free (per-host arrays.npz
written independently when params are host-local shards).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.training.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.fault_tolerance")


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures_recovered: int = 0
    straggler_events: int = 0
    ckpt_fallbacks: int = 0    # corrupt checkpoints skipped on restore
    restarts: List[int] = field(default_factory=list)
    final_metrics: Optional[Dict[str, Any]] = None


class TrainSupervisor:
    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 ckpt: CheckpointManager, *, max_retries: int = 3,
                 straggler_factor: float = 3.0, ema_decay: float = 0.9):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics);
        batch_fn(step) -> batch (deterministic in step)."""
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.ema_decay = ema_decay
        self.failure_hook: Optional[Callable[[int], None]] = None  # tests

    def run(self, params, opt_state, n_steps: int,
            start_step: int = 0) -> tuple:
        report = SupervisorReport()
        step = start_step
        retries = 0
        ema: Optional[float] = None
        while step < n_steps:
            t0 = time.monotonic()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)      # may raise (fault injection)
                batch = self.batch_fn(step)
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                report.final_metrics = metrics
            except Exception as e:   # noqa: BLE001 -- any step fault
                retries += 1
                report.failures_recovered += 1
                report.restarts.append(step)
                log.warning("step %d failed (%s); restoring", step, e)
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {retries} times") from e
                skipped0 = len(getattr(self.ckpt, "corrupt_skipped", ()))
                restored = self.ckpt.restore_latest()
                report.ckpt_fallbacks += len(getattr(
                    self.ckpt, "corrupt_skipped", ())) - skipped0
                if restored is not None:
                    ckpt_step, params, opt_state = restored
                    step = ckpt_step
                # else: retry from current in-memory state
                continue
            retries = 0
            dt = time.monotonic() - t0
            if ema is not None and dt > self.straggler_factor * ema:
                report.straggler_events += 1
                log.warning("straggler: step %d took %.3fs (EMA %.3fs)",
                            step, dt, ema)
            ema = dt if ema is None else \
                self.ema_decay * ema + (1 - self.ema_decay) * dt
            step += 1
            report.steps_run += 1
            self.ckpt.maybe_save(step, params, opt_state)
        self.ckpt.wait()
        return params, opt_state, report
