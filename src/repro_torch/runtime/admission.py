"""Bounded admission control: shed policies and queue-wait TTLs (§15).

The port's copy of ``repro.runtime.admission``, over the port's
``Request``/``RequestQueue``.

``RequestQueue`` grows without bound — under sustained overload every
admitted request's queue wait (and therefore its latency) grows without
bound too, and goodput collapses while the engine dutifully serves requests
whose callers gave up long ago. :class:`AdmissionQueue` is the bounded
subclass the hardened serving loop uses instead:

* ``capacity`` bounds the queue; an arrival beyond it *sheds* per
  ``shed_policy``:
    - ``"reject-new"``  — the arriving request is dropped (back-pressure
                          lands on the newest caller, queued work is never
                          disturbed);
    - ``"drop-oldest"`` — the oldest queued request is dropped to make room
                          (its wait was longest, so its residual value is
                          lowest under a deadline);
    - ``"priority"``    — the lowest-priority queued request strictly below
                          the arrival is dropped; if none is, the arrival
                          itself is rejected (priority inversion never sheds
                          paid-for work for cheaper work).
* ``queue_ttl_s`` sheds requests that have waited in queue longer than the
  TTL *before* admission (a per-request ``Request.ttl_s`` overrides it) —
  the queue-wait half of the deadline story; the decode half lives in the
  batcher (``Request.deadline_s`` cancels mid-stream).

Every shed is accounted exactly: the request lands in ``self.shed`` with
``shed_reason`` set, and the optional metrics registry counts
``admission_shed_total{reason=...}`` — the drop accounting the overload
bench's goodput arithmetic audits against.

With ``capacity=None`` and no TTL the queue is behaviourally identical to
``RequestQueue`` — the hardening is inert until configured, which is what
keeps un-hardened streams bitwise identical to the pre-§15 engine.
"""

from __future__ import annotations

import heapq

from .scheduler import Request, RequestQueue

SHED_POLICIES = ("reject-new", "drop-oldest", "priority")


class AdmissionQueue(RequestQueue):
    """Bounded, TTL-aware arrival queue with explicit shed policies."""

    def __init__(
        self,
        requests=(),
        *,
        capacity: int | None = None,
        shed_policy: str = "reject-new",
        queue_ttl_s: float | None = None,
        registry=None,
        trace=None,
    ):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {shed_policy!r}"
            )
        if queue_ttl_s is not None and queue_ttl_s <= 0:
            raise ValueError(f"queue_ttl_s must be > 0, got {queue_ttl_s}")
        self.capacity = capacity
        self.shed_policy = shed_policy
        self.queue_ttl_s = queue_ttl_s
        self.shed: list[Request] = []
        self._registry = registry
        self._qtrace = trace
        # TTL filtering costs an O(n) heap pass per pop_due; skip it
        # entirely unless some request can actually expire.
        self._ttl_armed = queue_ttl_s is not None
        super().__init__(requests)

    # --------------------------------------------------------------- shedding
    def _note_shed(self, req: Request, reason: str) -> None:
        req.shed_reason = reason
        self.shed.append(req)
        if self._registry is not None:
            self._registry.inc("admission_shed_total", reason=reason)
        if self._qtrace is not None:
            self._qtrace.emit(
                "shed", "scheduler",
                args={"rid": req.rid, "reason": reason},
            )

    def submit(self, req: Request) -> None:
        if req.ttl_s is not None:
            self._ttl_armed = True
        if self.capacity is None:
            super().submit(req)
            return
        victim = None
        with self._lock:
            if len(self._heap) < self.capacity:
                heapq.heappush(
                    self._heap, (req.arrival_s, next(self._tie), req)
                )
            elif self.shed_policy == "drop-oldest":
                victim = heapq.heappop(self._heap)[2]
                heapq.heappush(
                    self._heap, (req.arrival_s, next(self._tie), req)
                )
            elif self.shed_policy == "priority":
                # lowest-priority queued entry, oldest first on ties
                i = min(
                    range(len(self._heap)),
                    key=lambda j: (self._heap[j][2].priority, self._heap[j][:2]),
                )
                if self._heap[i][2].priority < req.priority:
                    victim = self._heap[i][2]
                    self._heap[i] = self._heap[-1]
                    self._heap.pop()
                    heapq.heapify(self._heap)
                    heapq.heappush(
                        self._heap, (req.arrival_s, next(self._tie), req)
                    )
                else:
                    victim = req  # nothing cheaper queued: reject the arrival
            else:  # reject-new
                victim = req
        if victim is not None:
            self._note_shed(victim, self.shed_policy)

    # -------------------------------------------------------------- admission
    def _expire(self, now: float) -> None:
        """Shed every queued request whose queue wait exceeded its TTL."""
        expired: list[Request] = []
        with self._lock:
            kept = []
            for item in self._heap:
                req = item[2]
                ttl = req.ttl_s if req.ttl_s is not None else self.queue_ttl_s
                if ttl is not None and now - req.arrival_s > ttl:
                    expired.append(req)
                else:
                    kept.append(item)
            if expired:
                self._heap = kept
                heapq.heapify(self._heap)
        for req in expired:
            self._note_shed(req, "ttl")

    def pop_due(self, now: float, limit: int | None = None):
        if self._ttl_armed:
            self._expire(now)
        return super().pop_due(now, limit)
