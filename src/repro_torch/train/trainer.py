"""The training loop with fault tolerance and a step watchdog
(``repro/train/trainer.py``).

  * **Checkpoint/restart** -- atomic checkpoints every ``checkpoint_every``
    steps with the data pipeline's state; ``run()`` resumes from the
    newest one, so a killed run re-invoked goes on where it stopped.
    ``checkpoint_every`` <= 0 writes none (the reference's would divide by
    zero): a run that only measures steps, whose state is gigabytes.
  * **Failure handling** -- a failure raised mid-step (``FailureInjector``
    in tests) is caught, the state is restored from the last checkpoint
    and the run continues: bit for bit the run that never failed, since
    every batch is a pure function of (seed, step).  A run that writes no
    checkpoints has nothing to restore from, so there the failure (a
    straggler restart too) is raised to the caller.
  * **Straggler watch** -- ``StepWatchdog`` keeps an EWMA of step times,
    counts steps slower than ``factor`` times it, and asks for a restart
    (checkpoint, then raise) after ``max_straggler_steps`` in a row.

Sharded state and batches (``state_shardings``, ``batch_shardings``: trees
of ``launch/sharding.py::NamedSharding``, as ``launch/train.py`` builds
them) make the run a DTensor program on a mesh: each batch is placed by
``data/pipeline.py::shard_batch``, a checkpoint saves each leaf whole
(``full_tensor()``, the same file on any mesh), and a restore puts each
leaf back under its placements.  The port has no ``jax.eval_shape``: the
restore template is ``make_state()`` itself, whose leaves give the shapes,
dtypes and devices the restored state takes.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import shard_batch

log = logging.getLogger("repro_torch.trainer")


class FailureInjector:
    """Deterministic fault injection for tests: fail at given steps."""

    def __init__(self, fail_at=(), exc=RuntimeError):
        self.fail_at = set(fail_at)
        self.exc = exc
        self.history = []

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.history.append(step)
            raise self.exc(f"injected node failure at step {step}")


class StepWatchdog:
    def __init__(self, factor: float = 3.0, max_straggler_steps: int = 5):
        self.ewma: Optional[float] = None
        self.factor = factor
        self.max_straggler_steps = max_straggler_steps
        self.consecutive = 0
        self.straggler_steps = []

    def observe(self, step: int, dt: float) -> bool:
        """True when the straggler threshold demands a restart."""
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        self.ewma = 0.9 * self.ewma + 0.1 * dt
        if slow:
            self.straggler_steps.append(step)
            self.consecutive += 1
            log.warning("straggler step %d: %.3fs (ewma %.3fs)", step, dt,
                        self.ewma)
        else:
            self.consecutive = 0
        return self.consecutive >= self.max_straggler_steps


def _host(v) -> float:
    """A metric as a Python float (a DTensor's whole value)."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    return float(v)


def _sync(metrics: Dict[str, Any]) -> None:
    """Wait for the step's device work (its metrics are its last results)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


class Trainer:
    """Supervised train loop: ``step_fn(state, batch) -> (state,
    metrics)`` over ``pipeline.batch_at(step)``, with recovery."""

    def __init__(self, cfg: TrainConfig, *, make_state: Callable[[], Any],
                 step_fn: Callable, pipeline, state_shardings=None,
                 batch_shardings=None,
                 failure_injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings
        self.make_state = make_state
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.ckpt = Checkpointer(cfg.checkpoint_dir,
                                 keep=cfg.keep_checkpoints)
        self.failure_injector = failure_injector
        self.watchdog = StepWatchdog()
        self.metrics_history: list = []
        self.recoveries = 0

    def _try_restore(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return None
        state, step, extra = self.ckpt.restore(
            self.make_state(), shardings=self.state_shardings)
        self.pipeline.load_state_dict(extra["pipeline"])
        log.info("restored checkpoint step=%d", step)
        return state, step

    def _save(self, step: int, state, blocking=False):
        if self.cfg.checkpoint_every <= 0:
            return
        self.ckpt.save(step, state,
                       extra={"pipeline": self.pipeline.state_dict()},
                       blocking=blocking)

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train to ``steps`` (default ``cfg.steps``), recovering from up
        to 10 failures (none when ``checkpoint_every`` <= 0).  Returns
        {"state", "metrics", "history", "recoveries"}."""
        steps = steps or self.cfg.steps
        attempt = 0
        while True:
            try:
                return self._run_once(steps)
            except RuntimeError as e:
                if self.cfg.checkpoint_every <= 0:
                    raise
                attempt += 1
                self.recoveries += 1
                log.warning("step failure (%s); recovery #%d", e, attempt)
                if attempt > 10:
                    raise

    def _run_once(self, steps: int) -> Dict[str, Any]:
        restored = self._try_restore()
        if restored is None:
            state, start = self.make_state(), 0
        else:
            state, start = restored
            start += 1
        self.pipeline.step = start
        last_metrics: Dict[str, Any] = {}
        for step in range(start, steps):
            batch = self.pipeline.batch_at(step)
            self.pipeline.step = step + 1
            if self.batch_shardings is not None:
                batch = shard_batch(batch, self.batch_shardings)
            t0 = time.time()
            if self.failure_injector is not None:
                self.failure_injector.check(step)
            state, metrics = self.step_fn(state, batch)
            _sync(metrics)
            dt = time.time() - t0
            need_restart = self.watchdog.observe(step, dt)
            if step % self.cfg.log_every == 0 or step == steps - 1:
                host = {k: _host(v) for k, v in metrics.items()}
                host["step"] = step
                host["dt"] = dt
                self.metrics_history.append(host)
                log.info("step %d: %s", step, host)
            last_metrics = metrics
            if self.cfg.checkpoint_every > 0 and \
                    (step + 1) % self.cfg.checkpoint_every == 0:
                self._save(step, state)
            if need_restart:
                self._save(step, state, blocking=True)
                raise RuntimeError("straggler threshold exceeded")
        self.ckpt.wait()
        self._save(steps - 1, state, blocking=True)
        return {"state": state, "metrics": last_metrics,
                "history": self.metrics_history,
                "recoveries": self.recoveries}
