"""Slot-based continuous-batching serving core (``repro/serve/core.py``).

The port's copy of the reference's framework-free loop.  The LM
``ServeEngine`` and the GCN ``GraphServeEngine`` are the same loop with
different step bodies: an admission queue feeds a fixed set of
``max_batch`` *slots*; a finished request frees its slot and the next queued
request is admitted into it immediately (continuous batching -- no
wave barriers); per-request enqueue/finish walltimes accumulate into
latency percentiles and throughput.  This module owns that loop ONCE --
``SlotServeCore`` -- so LM decode and graph inference are two
instantiations of one serving core rather than parallel implementations.

Request protocol (duck-typed -- engines keep their own dataclasses): a
request must carry mutable ``done`` / ``enqueue_t`` / ``finish_t``
attributes; everything else (prompt, seeds, outputs) is engine-specific.

Subclass contract:

  * ``_admit_into_slot(slot, req) -> bool``: admit one queued request into
    a free slot (LM: prefill-into-slot; graph: sample + pad + bucket).
    Return True iff the request finished AT admission (e.g. the prefill's
    first token hit EOS) -- the core then records it without occupying the
    slot.
  * ``_step() -> list``: advance every active slot by one engine step (LM:
    one batched decode; graph: drain each slot through its bucket's
    compiled callable), calling ``_complete(slot)`` for each request that
    finished.  Runs only while slots are active.

``stats()`` reports the core's view -- steps, served, active, queued,
latency percentiles (p50/p95/p99 ms), throughput -- and engines extend it
with their own counters.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from repro_torch.profile.bench import latency_percentiles


class SlotServeCore:
    """The shared admission-queue + slot-lifecycle + stats serving loop.

    Engines subclass it with ``_admit_into_slot`` / ``_step`` (see the
    module docstring for the contract); ``submit`` / ``run`` / ``stats``
    are the public serving surface every engine shares.
    """

    def __init__(self, max_batch: int):
        self.max_batch = int(max_batch)
        self._queue: List[Any] = []
        self._active: Dict[int, Any] = {}   # slot -> request
        self._steps = 0
        self._served = 0
        self._latencies_s: List[float] = []
        self._slot_assignments = 0          # admissions into slots
        self._t_first_enqueue = None
        self._t_last_finish = None

    # --------------------------------------------------------------- public

    def submit(self, req) -> None:
        """Enqueue one request (stamps ``enqueue_t``); FIFO admission."""
        req.enqueue_t = time.time()
        if self._t_first_enqueue is None:
            self._t_first_enqueue = req.enqueue_t
        self._queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Any]:
        """Drive the loop until queue + active slots drain; returns the
        finished requests in completion order.  ``max_steps`` bounds the
        number of ``_step`` rounds (runaway guard)."""
        finished: List[Any] = []
        while (self._queue or self._active) and self._steps < max_steps:
            finished.extend(self.tick())
        return finished

    def tick(self) -> List[Any]:
        """ONE admission + step round; returns requests finished this
        round.  ``run`` is tick-until-drained (the closed loop); open-loop
        drivers instead interleave ticks with timed ``submit`` calls so
        arrivals keep landing while earlier requests are in flight --
        measured latency then includes queueing delay, not just service
        time.  A tick with nothing queued or active is a no-op."""
        if not (self._queue or self._active):
            return []
        finished = list(self._admit())
        finished.extend(self._step())
        return finished

    @property
    def outstanding(self) -> int:
        """Requests submitted but not yet finished (queued + active)."""
        return len(self._queue) + len(self._active)

    def stats(self) -> Dict[str, Any]:
        """Core serving stats: steps/served/active/queued, per-request
        latency percentiles (ms), and end-to-end throughput (requests/s
        from first enqueue to last finish)."""
        out: Dict[str, Any] = {
            "steps": self._steps,
            "served": self._served,
            "active": len(self._active),
            "queued": len(self._queue),
            "slot_assignments": self._slot_assignments,
        }
        out.update(latency_percentiles(self._latencies_s))
        dt = None
        if self._t_first_enqueue is not None and \
                self._t_last_finish is not None:
            dt = max(self._t_last_finish - self._t_first_enqueue, 1e-9)
        out["throughput_rps"] = (self._served / dt) if dt else 0.0
        return out

    @property
    def latencies_s(self) -> List[float]:
        """Per-request end-to-end latencies (seconds), completion order."""
        return list(self._latencies_s)

    # ------------------------------------------------------------- lifecycle

    def _admit(self) -> List[Any]:
        """Fill free slots from the queue; returns requests that finished
        at admission (the continuous-batching half of the loop)."""
        done_at_admit: List[Any] = []
        free = [s for s in range(self.max_batch) if s not in self._active]
        while free and self._queue:
            slot = free[0]
            req = self._queue.pop(0)
            self._slot_assignments += 1
            if self._admit_into_slot(slot, req):
                self._record_finish(req)
                done_at_admit.append(req)
                continue                    # slot stays free for the next
            free.pop(0)
            self._active[slot] = req
        return done_at_admit

    def _complete(self, slot: int):
        """Finish the request in ``slot`` and free the slot (engines call
        this from ``_step`` for every request that finished)."""
        req = self._active.pop(slot)
        self._record_finish(req)
        return req

    def _record_finish(self, req) -> None:
        req.done = True
        req.finish_t = time.time()
        self._t_last_finish = req.finish_t
        self._latencies_s.append(req.finish_t - req.enqueue_t)
        self._served += 1

    # ------------------------------------------------------------ subclasses

    def _admit_into_slot(self, slot: int, req) -> bool:
        raise NotImplementedError

    def _step(self) -> List[Any]:
        raise NotImplementedError
