"""The port's dispatch core held against the JAX package's (twins of
``tests/test_dispatch.py``, less its two fault-plan tests, which come with
the overload stack): the single-flight compile cache, bounded eviction and
pinning, the hysteresis policy, ``set_direction``, the warmer, ``hot`` on an
empty slot, and ``SpecTable.prewarm``.

Each scenario runs through ``repro.core`` and ``repro_torch.core`` alike and
the observable results — served values, slot keys, counters — must agree.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

pytest.importorskip("jax")  # the card's machine has no JAX
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore

CORES = pytest.mark.parametrize("core", [jcore, tcore], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean_registry():
    jcore.reset_entry_points()
    tcore.reset_entry_points()
    yield
    jcore.reset_entry_points()
    tcore.reset_entry_points()


def _both(scenario):
    """Run ``scenario(core)`` on both packages; their results must agree."""
    jout, tout = scenario(jcore), scenario(tcore)
    assert jout == tout
    return tout


# ------------------------------------------------------------- CompileCache
def test_cache_build_once_then_hit():
    def scenario(core):
        c = core.CompileCache("t")
        calls = []
        exe = c.get_or_build("a", lambda: calls.append(1) or (lambda: 42))
        again = c.get_or_build("a", lambda: calls.append(1) or (lambda: 0))
        assert again is exe
        return (calls, c.stats.misses, c.stats.hits, "a" in c, len(c),
                c.keys(), c.get("a")())

    assert _both(scenario) == ([1], 1, 1, True, 1, ("a",), 42)


@CORES
def test_cache_get_never_builds(core):
    c = core.CompileCache("t")
    with pytest.raises(KeyError, match="precompile"):
        c.get("missing")
    assert len(c) == 0 and c.stats.misses == 0


def test_cache_lru_eviction_and_pinning():
    def scenario(core):
        c = core.CompileCache("t", capacity=2)
        for k in ("a", "b", "x"):
            c.get_or_build(k, lambda k=k: k)
        first = ("a" in c, len(c), c.stats.evictions)
        c.pin("b")
        c.get_or_build("y", lambda: "y")  # would evict b, but b is pinned
        return first, "b" in c, "x" in c, c.keys()

    assert _both(scenario) == ((False, 2, 1), True, False, ("b", "y"))


@CORES
def test_cache_capacity_validation(core):
    with pytest.raises(core.DispatchError, match="capacity"):
        core.CompileCache("t", capacity=0)


@CORES
def test_cache_single_flight_builds_once(core):
    """Paper §5.2 table edition: racing cold-path threads build once."""
    c = core.CompileCache("race")
    builds = []

    def slow_build():
        time.sleep(0.05)
        builds.append(1)
        return lambda: 42

    results = []
    threads = [
        threading.Thread(
            target=lambda: results.append(c.get_or_build("k", slow_build))
        )
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert len(results) == 8 and all(r() == 42 for r in results)
    assert c.stats.single_flight_waits >= 1


@CORES
def test_cache_leader_failure_releases_followers(core):
    c = core.CompileCache("fail")
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            time.sleep(0.02)
            raise RuntimeError("compile exploded")
        return "ok"

    errs, oks = [], []

    def worker():
        try:
            oks.append(c.get_or_build("k", flaky))
        except RuntimeError as e:
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the leader raised; followers retried and built successfully
    assert len(errs) == 1 and set(oks) == {"ok"}


@CORES
def test_spec_table_is_single_flight(core):
    """SpecTable (the legacy interface) inherits single-flight builds."""
    t = core.SpecTable("sf")
    builds = []

    def build():
        time.sleep(0.03)
        builds.append(1)
        return lambda: 7

    threads = [
        threading.Thread(target=lambda: t.get_or_build("k", build))
        for _ in range(6)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(builds) == 1
    assert t.stats.misses == 1
    assert isinstance(t.stats, core.SpecStats)


def test_spec_table_prewarm():
    """prewarm runs an already-built entry (and waits for it); a key never
    built raises KeyError, in both packages."""
    def scenario(core):
        t = core.SpecTable("pw")
        ran = []
        t.get_or_build("k", lambda: (lambda x: ran.append(x) or x))
        t.prewarm("k", (3,))
        with pytest.raises(KeyError):
            t.prewarm("missing", (3,))
        return ran, t.stats.hits, t.stats.misses

    assert _both(scenario) == ([3], 1, 1)
    t = tcore.SpecTable("pw-tensor")
    t.get_or_build("k", lambda: (lambda x: (x + 1, [x * 2])))
    t.prewarm("k", (torch.ones(2),))  # tensor outputs in a tree: no device


# --------------------------------------------------------------- Dispatcher
def test_dispatch_builds_and_rebinds_immediately_by_default():
    def scenario(core):
        d = core.Dispatcher(lambda k: (lambda: k), name="d")
        served = d.dispatch("A")()
        first = d.current_key
        d.dispatch("B")
        return (served, first, d.current_key, d.stats.rebinds,
                d.stats.misses, d.hot(), d())

    assert _both(scenario) == ("A", "A", "B", 2, 2, "B", "B")


def test_dispatch_slot_hit_is_fast_path():
    def scenario(core):
        d = core.Dispatcher(lambda k: (lambda: k), name="d")
        d.dispatch("A")
        before = d.stats.slot_hits
        d.dispatch("A")
        return d.stats.slot_hits - before, d.stats.misses, d.stats.hits

    assert _both(scenario) == (1, 1, 1)


def test_hysteresis_suppresses_oscillation():
    """Fig. 13 as policy: rapid A/B/A/B never moves the slot."""
    def scenario(core):
        d = core.Dispatcher(
            lambda k: (lambda: k), name="d",
            policy=core.DispatchPolicy(hysteresis=2),
        )
        d.dispatch("A")
        d.dispatch("A")
        served = []
        for _ in range(8):
            served += [d.dispatch("B")(), d.dispatch("A")()]
        return (d.current_key, served, d.stats.suppressed_rebinds,
                d.stats.table_dispatches)

    key, served, suppressed, table = _both(scenario)
    assert key == "A" and served == ["B", "A"] * 8 and suppressed >= 8


def test_hysteresis_streak_captures_slot():
    def scenario(core):
        d = core.Dispatcher(
            lambda k: (lambda: k), name="d",
            policy=core.DispatchPolicy(hysteresis=3),
        )
        keys = []
        for k in ("A", "A", "A", "B", "B", "B"):
            d.dispatch(k)
            keys.append(d.current_key)
        return keys

    assert _both(scenario) == [None, None, "A", "A", "A", "B"]


def test_set_direction_bypasses_hysteresis():
    def scenario(core):
        d = core.Dispatcher(
            lambda k: (lambda: k), name="d",
            policy=core.DispatchPolicy(hysteresis=99),
        )
        exe = d.set_direction("A")
        return d.current_key, d.hot(), exe(), d.stats.rebinds

    assert _both(scenario) == ("A", "A", "A", 1)


@CORES
def test_policy_validation(core):
    with pytest.raises(core.DispatchError, match="hysteresis"):
        core.DispatchPolicy(hysteresis=0)


def test_slot_key_never_evicted():
    def scenario(core):
        d = core.Dispatcher(
            lambda k: (lambda: k), name="d",
            policy=core.DispatchPolicy(capacity=2),
        )
        d.set_direction("hot")
        for k in ("a", "b", "c", "e"):
            d.build(k)
        return "hot" in d, d.hot(), d.stats.evictions, len(d)

    assert _both(scenario) == (True, "hot", 3, 2)


@CORES
def test_duplicate_entry_point_guard_and_close(core):
    core.Dispatcher(lambda k: k, name="dup")
    with pytest.raises(core.DispatchError, match="entry point"):
        core.Dispatcher(lambda k: k, name="dup")
    assert "dup" in core.live_dispatchers()
    core.reset_entry_points()
    d = core.Dispatcher(lambda k: k, name="dup")  # no raise after reset
    d.close()
    core.Dispatcher(lambda k: k, name="dup")  # no raise after close
    core.reset_dispatchers()
    assert core.live_dispatchers() == ()


@CORES
def test_empty_slot_raises(core):
    d = core.Dispatcher(lambda k: k, name="d")
    with pytest.raises(core.DispatchError, match="empty hot slot"):
        d.hot()
    with pytest.raises(core.DispatchError, match="empty hot slot"):
        d()


def test_warmer_runs_on_rebind():
    def scenario(core):
        warmed = []
        d = core.Dispatcher(
            lambda k: (lambda: k), name="d",
            warmer=lambda key, exe: warmed.append((key, exe())),
            policy=core.DispatchPolicy(warm_on_rebind=True),
        )
        d.dispatch("A")
        first = list(warmed)
        d.dispatch("A")  # slot hit: no warm
        d.dispatch("B", warm=False)  # a rebind told not to warm
        d.set_direction("C", warm=True)
        snap = d.stats.snapshot()
        return (first, warmed, d.stats.warms, snap["warms"],
                d.stats.last_rebind_seconds >= 0.0)

    assert _both(scenario) == (
        [("A", "A")], [("A", "A"), ("C", "C")], 2, 2, True,
    )


def test_warmer_off_by_default():
    def scenario(core):
        warmed = []
        d = core.Dispatcher(lambda k: (lambda: k), name="d",
                            warmer=lambda key, exe: warmed.append(key))
        d.dispatch("A")
        d.set_direction("B")
        d.set_direction("C", warm=True)
        return warmed, d.stats.warms

    assert _both(scenario) == (["C"], 1)
