"""Deterministic fault injection for the serving stack (DESIGN.md §15).

The port's copy of ``repro.core.faults``: pure host bookkeeping, so it is
kept word for word apart from the module paths it names.

The overload/fault-hardening layer needs failures it can rehearse: a chaos
test that cannot reproduce a fault cannot gate its containment. This module
provides a seedable :class:`FaultPlan` that arms faults at *named sites* —
fixed choke points in the dispatcher, scheduler, page pool, and step loop —
by firing-opportunity ordinal, so the same plan against the same workload
injects the same faults at the same steps, every run.

Sites (each ``fire()`` call at a site counts one opportunity):

* ``step_output``  — one commit boundary (decode emit or verify apply).
                     The armed slot's next token is replaced with
                     :data:`POISON_TOKEN`, the int32 image of a
                     NaN-poisoned sample (tokens are int32, so a NaN/Inf in
                     the logits surfaces as an invalid token id; legitimate
                     samples are always >= 0). Detection is the scheduler's
                     NaN guard on emitted tokens; containment quarantines
                     the one affected slot.
* ``d2h_stall``    — one host-blocking device pull. The pull sleeps
                     ``stall_s`` (a simulated interconnect stall); detection
                     is the :class:`~repro_torch.ft.failover.StepTimeWatchdog`
                     wired into the step loop.
* ``build``        — one executable build on the dispatcher's cold path.
                     The single-flight leader raises :class:`InjectedFault`;
                     containment is a one-shot rebuild retry that exercises
                     the CompileCache's error path end to end.
* ``pool_alloc``   — one page allocation. The pool reports itself dry;
                     containment is the pre-existing evict -> preempt ->
                     defer admission machinery (no caller can tell injected
                     exhaustion from real exhaustion, by construction).
* ``heartbeat``    — one serving-loop heartbeat. The beat is suppressed;
                     detection is the :class:`~repro_torch.ft.failover.
                     HeartbeatMonitor` timeout, and the degradation
                     controller treats the loss as a forced bottom-rung
                     excursion (DESIGN.md §6 failover semantics).

The plan is pure host bookkeeping: a disarmed site costs one None-check at
its choke point, and a plan with no faults for a site costs one dict lookup
per opportunity — nothing rides the compiled hot path.
"""

from __future__ import annotations

from dataclasses import dataclass

SITES = ("step_output", "d2h_stall", "build", "pool_alloc", "heartbeat")

# The int32 image of a NaN-poisoned sample: far outside any vocabulary and
# negative, so the scheduler's emitted-token guard (``tok < 0``) is one
# integer compare per active slot — and never fires on a clean stream.
POISON_TOKEN = -(2**30)


class FaultError(RuntimeError):
    """Raised for fault-plan misuse (unknown site, bad ordinal)."""


class InjectedFault(RuntimeError):
    """The exception an injected ``build`` fault raises inside the
    single-flight leader. Containment code catches exactly this type —
    a real build failure still propagates."""

    def __init__(self, fault: "Fault"):
        self.fault = fault
        super().__init__(f"injected fault: {fault}")


@dataclass(frozen=True)
class Fault:
    """One armed fault: fire at opportunity ordinal ``at`` of ``site``
    (0-based, counted per site), for ``span`` consecutive opportunities.

    ``slot`` selects the victim for slot-scoped sites (taken modulo the
    number of eligible slots at fire time, so it always lands on a live
    one); ``stall_s`` is the simulated stall for ``d2h_stall``.
    """

    site: str
    at: int
    slot: int = 0
    stall_s: float = 0.0
    span: int = 1

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise FaultError(
                f"unknown fault site {self.site!r}; sites are {SITES}"
            )
        if self.at < 0 or self.span < 1:
            raise FaultError(
                f"fault needs at >= 0 and span >= 1, got at={self.at} "
                f"span={self.span}"
            )


class FaultPlan:
    """A deterministic schedule of faults plus detection/containment
    accounting.

    ``fire(site, ...)`` counts one opportunity at a site and returns the
    armed :class:`Fault` when its window covers the ordinal (else None).
    The injection site then *applies* the fault; whoever detects and
    contains it reports back through :meth:`note_detected` /
    :meth:`note_contained` — so the acceptance question "was every injected
    fault detected and contained?" is a plan-local comparison, and the
    optional metrics registry carries the same counts as
    ``faults_{injected,detected,contained}_total{site=...}``.
    """

    def __init__(self, faults=(), *, registry=None):
        self._by_site: dict[str, list[Fault]] = {}
        for f in faults:
            if not isinstance(f, Fault):
                raise FaultError(f"expected a Fault, got {type(f).__name__}")
            self._by_site.setdefault(f.site, []).append(f)
        self._opportunities = dict.fromkeys(SITES, 0)
        self.registry = registry
        self.injected: list[tuple[str, int]] = []  # (site, ordinal)
        self.detected: dict[str, int] = {}
        self.contained: dict[str, int] = {}

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        sites=SITES,
        n: int = 4,
        horizon: int = 64,
        stall_s: float = 0.02,
        registry=None,
    ) -> "FaultPlan":
        """Seedable chaos: ``n`` faults over the first ``horizon``
        opportunities of the given sites. Same seed, same plan."""
        import numpy as np

        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n):
            site = sites[int(rng.integers(len(sites)))]
            faults.append(
                Fault(
                    site=site,
                    at=int(rng.integers(horizon)),
                    slot=int(rng.integers(64)),
                    stall_s=stall_s,
                )
            )
        return cls(faults, registry=registry)

    # ------------------------------------------------------------- injection
    def fire(self, site: str) -> Fault | None:
        """Count one opportunity at ``site``; return the armed fault (or
        None). A fault whose [at, at+span) window covers the ordinal fires;
        overlapping faults fire earliest-armed first."""
        n = self._opportunities.get(site)
        if n is None:
            raise FaultError(
                f"unknown fault site {site!r}; sites are {SITES}"
            )
        self._opportunities[site] = n + 1
        for f in self._by_site.get(site, ()):
            if f.at <= n < f.at + f.span:
                self.injected.append((site, n))
                if self.registry is not None:
                    self.registry.inc("faults_injected_total", site=site)
                return f
        return None

    # ------------------------------------------------------------ accounting
    def note_detected(self, site: str) -> None:
        self.detected[site] = self.detected.get(site, 0) + 1
        if self.registry is not None:
            self.registry.inc("faults_detected_total", site=site)

    def note_contained(self, site: str) -> None:
        self.contained[site] = self.contained.get(site, 0) + 1
        if self.registry is not None:
            self.registry.inc("faults_contained_total", site=site)

    @property
    def total_injected(self) -> int:
        return len(self.injected)

    @property
    def total_detected(self) -> int:
        return sum(self.detected.values())

    @property
    def total_contained(self) -> int:
        return sum(self.contained.values())

    def report(self) -> dict:
        """Per-site injected/detected/contained summary (the chaos-matrix
        acceptance surface)."""
        by_site: dict[str, int] = {}
        for site, _ in self.injected:
            by_site[site] = by_site.get(site, 0) + 1
        return {
            "injected": by_site,
            "detected": dict(self.detected),
            "contained": dict(self.contained),
            "opportunities": {
                s: c for s, c in self._opportunities.items() if c
            },
        }
