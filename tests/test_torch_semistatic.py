"""The port's BranchChanger, semi_static and buckets held against the JAX
package's (twins of ``tests/test_semistatic.py``).

The same numpy inputs and directions go through ``repro.core.BranchChanger``
and ``repro_torch.core.BranchChanger(device="cpu")``; outputs agree to 1e-6
(both compute in fp32). The JAX file's two property tests draw from
hypothesis; their twins here run fixed direction sequences and sizes, so
they run where hypothesis is not installed. On the card each branch is a
captured CUDA graph: ``tests/test_torch_graphs.py`` holds that.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore
from repro_torch.core import (
    BranchChanger,
    BranchChangerError,
    SpecTable,
    bucket_multiple,
    bucket_pow2,
    semi_static,
    semi_static_switch,
)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_registry():
    jcore.reset_entry_points()
    tcore.reset_entry_points()
    yield
    jcore.reset_entry_points()
    tcore.reset_entry_points()


def _pair(jfns, tfns, name, shape):
    """One JAX and one port BranchChanger over the same branches, compiled
    against the same (shape, float32) input."""
    jbc = jcore.BranchChanger(*jfns, name=name)
    jbc.compile(jax.ShapeDtypeStruct(shape, jnp.float32))
    tbc = BranchChanger(*tfns, name=name, device="cpu")
    tbc.compile(torch.zeros(shape))
    return jbc, tbc


def _same(jout, tout):
    np.testing.assert_allclose(
        np.asarray(jout), tout.numpy(), rtol=RTOL, atol=RTOL
    )


def test_two_way_directions():
    jbc, tbc = _pair([lambda x: x + 1, lambda x: x - 1],
                     [lambda x: x + 1, lambda x: x - 1], "t", (4,))
    x = np.zeros(4, np.float32)
    for d, want in ((True, 1.0), (False, -1.0)):
        jbc.set_direction(d)
        tbc.set_direction(d)
        _same(jbc.branch(jnp.asarray(x)), tbc.branch(torch.from_numpy(x)))
        assert float(tbc.branch(torch.from_numpy(x))[0]) == want


def test_nary_switch():
    fns = [lambda x, i=i: x * 0 + i for i in range(5)]
    jbc, tbc = _pair(fns, fns, "nary", (2,))
    x = np.zeros(2, np.float32)
    for i in [3, 0, 4, 2, 1]:
        jbc.set_direction(i)
        tbc.set_direction(i)
        _same(jbc.branch(jnp.asarray(x)), tbc.branch(torch.from_numpy(x)))
        assert tbc.direction == jbc.direction == i


def test_uncompiled_eager_mode():
    jbc = jcore.BranchChanger(lambda x: x * 2, lambda x: x * 3, name="eager")
    tbc = BranchChanger(lambda x: x * 2, lambda x: x * 3, name="eager",
                        device="cpu")
    jbc.set_direction(False)
    tbc.set_direction(False)
    assert not tbc.is_compiled
    _same(jbc.branch(jnp.ones(())), tbc.branch(torch.ones(())))
    assert float(tbc.branch(torch.ones(()))) == 3.0


def test_duplicate_entry_point_guard():
    BranchChanger(lambda: 1, lambda: 2, name="dup", device="cpu")
    with pytest.raises(BranchChangerError, match="entry point"):
        BranchChanger(lambda: 1, lambda: 2, name="dup", device="cpu")
    assert tcore.live_entry_points() == ("dup",)


def test_close_releases_entry_point():
    bc = BranchChanger(lambda: 1, lambda: 2, name="dup2", device="cpu")
    bc.close()
    with BranchChanger(lambda: 1, lambda: 2, name="dup2", device="cpu"):
        assert "dup2" in tcore.live_entry_points()
    assert "dup2" not in tcore.live_entry_points()


def test_incompatible_signatures_guard():
    """The displacement guard: both packages refuse branches whose outputs
    differ in shape or dtype."""
    with pytest.raises(jcore.BranchChangerError, match="calling convention"):
        jcore.BranchChanger(
            lambda x: x, lambda x: jnp.zeros((7,), jnp.int32), name="sig"
        ).compile(jax.ShapeDtypeStruct((4,), jnp.float32))
    bc = BranchChanger(
        lambda x: x, lambda x: torch.zeros(7, dtype=torch.int32), name="sig",
        device="cpu",
    )
    with pytest.raises(BranchChangerError, match="calling convention"):
        bc.compile(torch.zeros(4))
    dt = BranchChanger(lambda x: x, lambda x: x.double(), name="sig-dtype",
                       device="cpu")
    with pytest.raises(BranchChangerError, match="calling convention"):
        dt.compile(torch.zeros(4))


def test_direction_out_of_range():
    bc = BranchChanger(lambda: 1, lambda: 2, name="rng", device="cpu")
    with pytest.raises(BranchChangerError, match="out of range"):
        bc.set_direction(5)
    with pytest.raises(BranchChangerError, match="out of range"):
        bc.set_direction(-1)
    with pytest.raises(BranchChangerError, match="host value"):
        bc.set_direction(torch.tensor(True))


def test_warm_counts_and_works():
    jbc, tbc = _pair([lambda x: x + 1, lambda x: x - 1],
                     [lambda x: x + 1, lambda x: x - 1], "warm", (4,))
    jbc.set_direction(True, warm=True)
    tbc.set_direction(True, warm=True)
    assert tbc.stats.warms == jbc.stats.warms == 1
    tbc.set_direction_safe(False, warm=True, warm_args=(torch.ones(4),))
    assert tbc.stats.warms == 2 and tbc.stats.switches == 2
    assert tbc.stats.compiles == jbc.stats.compiles == 2


def test_warm_before_compile_needs_args():
    bc = BranchChanger(lambda x: x, lambda x: -x, name="cold", device="cpu")
    with pytest.raises(BranchChangerError, match="warm_args"):
        bc.warm()


@pytest.mark.parametrize("directions", [
    [0], [2, 2, 2], [0, 1, 2, 1, 0], [1, 0, 2, 0, 1, 1, 2, 2, 0, 1],
])
def test_switch_matches_the_jax_changer_and_lax_switch(directions):
    """Any direction sequence: the port's result == the JAX BranchChanger's
    == the lax.switch oracle (the property test, over fixed sequences)."""
    jfns = [lambda x: x + 1.0, lambda x: x * 2.0, lambda x: x - 3.0]
    jbc, tbc = _pair(jfns, jfns, "prop", (3,))
    x = np.arange(3.0, dtype=np.float32)

    @jax.jit
    def oracle(i, x):
        return jax.lax.switch(i, jfns, x)

    for d in directions:
        jbc.set_direction(d)
        tbc.set_direction(d)
        got = tbc.branch(torch.from_numpy(x))
        _same(jbc.branch(jnp.asarray(x)), got)
        _same(oracle(d, jnp.asarray(x)), got)


def test_single_writer_thread_safety():
    """Hot readers never observe a torn/invalid target while one writer flips."""
    bc = BranchChanger(lambda x: x * 0 + 1, lambda x: x * 0 + 2, name="mt",
                       device="cpu")
    bc.compile(torch.zeros(2))
    bc.set_direction(True)
    stop = threading.Event()
    bad = []

    def writer():
        d = True
        while not stop.is_set():
            d = not d
            bc.set_direction(d)

    def reader():
        x = torch.zeros(2)
        while not stop.is_set():
            v = float(bc.branch(x)[0])
            if v not in (1.0, 2.0):
                bad.append(v)

    ts = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)
    ]
    for t in ts:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in ts:
        t.join()
    assert not bad and bc.stats.switches > 1


def test_semi_static_runs_one_branch():
    """Only the selected branch runs (the JAX twin: only its ops are
    staged); the device conditional computes both and selects."""
    calls = []

    def heavy(x):
        calls.append("heavy")
        return x @ x.T

    def light(x):
        calls.append("light")
        return x

    x = torch.ones(8, 8)
    out = semi_static(False, heavy, light, x)
    assert calls == ["light"] and torch.equal(out, x)
    jout = jcore.semi_static(False, lambda v: v @ v.T, lambda v: v,
                             jnp.ones((8, 8)))
    _same(jout, out)
    calls.clear()
    torch.where(torch.tensor(False), heavy(x), light(x))
    assert calls == ["heavy", "light"]


def test_semi_static_rejects_tensors():
    """A tensor condition raises (the JAX package's tracer rejection):
    reading a device value would synchronise, and fails under capture."""
    with pytest.raises(BranchChangerError, match="host"):
        semi_static(torch.tensor(True), lambda: 1, lambda: 2)
    with pytest.raises(BranchChangerError, match="host"):
        semi_static_switch(torch.tensor(1), [lambda: 1, lambda: 2])
    assert semi_static(True, lambda: 1, lambda: 2) == 1


def test_semi_static_switch_bounds():
    with pytest.raises(BranchChangerError, match="out of range"):
        semi_static_switch(3, [lambda: 1, lambda: 2])
    with pytest.raises(jcore.BranchChangerError, match="out of range"):
        jcore.semi_static_switch(3, [lambda: 1, lambda: 2])
    assert semi_static_switch(1, [lambda: 1, lambda: 2]) == 2


def test_spec_table():
    t = SpecTable("t")
    calls = []
    t.get_or_build("a", lambda: calls.append(1) or (lambda: 42))
    assert t.get_or_build("a", lambda: calls.append(1) or (lambda: 0))() == 42
    assert len(calls) == 1
    assert t.stats.misses == 1 and t.stats.hits == 1
    with pytest.raises(KeyError, match="precompile"):
        t.get("missing")


@pytest.mark.parametrize("n", [1, 3, 4, 7, 8, 9, 63, 64, 65, 1000, 1024,
                               1025, 4096])
def test_buckets_match_the_jax_package(n):
    b = bucket_pow2(n, 8, 1024)
    assert b == jcore.bucket_pow2(n, 8, 1024)
    assert b >= min(n, 1024) and b <= 1024 and (b & (b - 1)) == 0
    m = bucket_multiple(n, 4, 1024)
    assert m == jcore.bucket_multiple(n, 4, 1024)
    assert m % 4 == 0 and m >= min(n, 4)


def test_cuda_changer_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal does not apply")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BranchChanger(lambda x: x, lambda x: -x, name="gpu")
    assert "gpu" not in tcore.live_entry_points()
