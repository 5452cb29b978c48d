"""The mesh coordinate on one-device plans (DESIGN.md §16-§17), against the
JAX package's ``repro.distributed.sharding``.

Mesh and slice names parse as the reference parses them, valid or not (the
same exception type); ``MeshPlan``'s shape fields and ``DisaggPlan``'s
overlap check and ``split`` agree. The engine: a plan of more than one
device serves the paged and the dense lanes, a slice past
``EngineConfig.devices`` raises ``ValueError``, and ``set_mesh`` keeps the
reference's in-process contract (``tests/test_sharding.py``: an unwarmed
mesh refused, a no-op flip, no control surface, refused while
disaggregated). A warmed one-device slice on a second logical CPU device
is a real flip mid-stream: tokens equal the unflipped stream's, one mesh
rebind, no build after warmup. olmo-1b smoke, fp32, one torch thread.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tshd
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ENGINE = dict(max_len=32, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=20, prefill_chunk=8)
NAMES = ("1x1", "1,1", " 2X2 ", "1x2", "1x1@1", "2x1@3", "1x1@0", "4,2@2",
         "x1", "1x", "0x1", "1x0", "1x1@-1", "1x1@a", "axb", "1x2x3", "",
         "1x1@")


@pytest.fixture(scope="module")
def jshd():
    pytest.importorskip("jax")
    from repro.distributed import sharding

    return sharding


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return "raise", type(e)


@pytest.mark.parametrize("name", NAMES)
def test_names_and_plans_parse_as_the_reference(jshd, name):
    for fn in ("parse_slice_name", "parse_mesh_name"):
        assert _outcome(getattr(tshd, fn), name) == _outcome(
            getattr(jshd, fn), name)
    if _outcome(tshd.parse_slice_name, name)[0] == "ok":
        t, j = tshd.MeshPlan(name), jshd.MeshPlan(name)
        fields = ("name", "dp", "mp", "offset", "single", "solo",
                  "num_devices")
        assert [getattr(t, f) for f in fields] == [getattr(j, f)
                                                   for f in fields]
        assert tshd.mesh_name(t.dp, t.mp, t.offset) == jshd.mesh_name(
            j.dp, j.mp, j.offset)
    assert tshd.SERVING_AXES == jshd.SERVING_AXES


@pytest.mark.parametrize("pair", [
    ("1x1@1", "1x1"), ("1x1", "1x1"), ("1x2@1", "1x1"), ("1x1@2", "2x1"),
    ("1,1@1", "1,1"), ("1x2@2", "1x2"), ("1x2@1", "1x2"), ("1x1@1", "2x1"),
])
def test_disagg_plan_overlap_as_the_reference(jshd, pair):
    t = _outcome(lambda: tshd.DisaggPlan(*pair))
    j = _outcome(lambda: jshd.DisaggPlan(*pair))
    assert t[0] == j[0]
    if t[0] == "ok":
        assert (t[1].prefill, t[1].decode) == (j[1].prefill, j[1].decode)
    else:
        assert t[1] is j[1] is ValueError


@pytest.mark.parametrize("base", ["2x1", "3x2", "2x2@1", "1x1", "1x4",
                                  "2x2", "3x1"])
def test_disagg_split_as_the_reference(jshd, base):
    t = _outcome(tshd.DisaggPlan.split, base)
    j = _outcome(jshd.DisaggPlan.split, base)
    assert t[0] == j[0]
    if t[0] == "ok":
        assert (t[1].prefill, t[1].decode) == (j[1].prefill, j[1].decode)
    else:
        assert t[1] is j[1]


@pytest.mark.parametrize("base,want", [
    ("2x2", ("1x2@2", "1x2")), ("3x1", ("1x1@2", "2x1")),
    ("2x1", ("1x1@1", "1x1")),
])
def test_disagg_split_of_a_multi_device_base(base, want):
    """The splits the multi-device disaggregation serves
    (``tests/test_torch_disagg_mesh.py``): the last data row prefills."""
    plan = tshd.DisaggPlan.split(base)
    assert (plan.prefill, plan.decode) == want


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("olmo-1b").smoke()
    return cfg, models.init_params(cfg, seed=0)


def _engine(smoke, **kw) -> Engine:
    cfg, params = smoke
    return Engine(cfg, params, EngineConfig(**ENGINE, **kw), device="cpu")


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2@1"])
def test_a_plan_of_more_than_one_device_raises(smoke, mesh):
    """A plan of more than one logical device: the paged engine and the
    dense engine (ROADMAP A12 part 3, item 2) warm it and serve on it, each
    with the same tokens as the plain engine's."""
    cfg, _ = smoke
    with _engine(smoke, devices=("cpu",) * 5) as eng:
        want = _serve(eng.paged_continuous(slots=4), _reqs(cfg.vocab_size))
        want_dense = _serve(eng.continuous(slots=4), _reqs(cfg.vocab_size))
    with _engine(smoke, meshes=(mesh,), devices=("cpu",) * 5) as eng:
        dense = eng.continuous(slots=4, mesh=mesh)
        assert ("cb", 4, shd_name(mesh)) in eng._decode
        assert _serve(dense, _reqs(cfg.vocab_size)) == want_dense
        cb = eng.paged_continuous(slots=4, mesh=mesh)
        assert cb.mesh == shd_name(mesh)
        assert ("cbp", 4, 1, "fp32", shd_name(mesh)) in eng._decode
        assert _serve(cb, _reqs(cfg.vocab_size)) == want
        assert eng.post_warmup_compiles == 0


def shd_name(mesh: str) -> str:
    return tshd.mesh_name(*tshd.parse_slice_name(mesh))


def test_a_slice_past_the_devices_raises(smoke):
    with _engine(smoke, meshes=("1x1@1",)) as eng:  # devices: ("cpu",)
        with pytest.raises(ValueError, match="needs device 1"):
            eng.paged_continuous(slots=4)
    with _engine(smoke, meshes=("1x1@2",), devices=("cpu", "cpu")) as eng:
        with pytest.raises(ValueError, match="needs device 2"):
            eng.paged_continuous(slots=4, disagg="1x1@2")


def test_unwarmed_mesh_is_rejected(smoke):
    with _engine(smoke) as eng:
        with pytest.raises(ValueError, match="warmed set"):
            eng.continuous(mesh="1x2")
        with pytest.raises(ValueError, match="warmed set"):
            eng.paged_continuous(mesh="2x2")


def test_set_mesh_validation_noop_and_surfaces(smoke):
    with _engine(smoke, meshes=("1x1@1",), devices=("cpu", "cpu")) as eng:
        cb = eng.paged_continuous(slots=4)
        assert cb.mesh == "1x1" and cb.pool.shards == 1
        assert cb.set_mesh("1,1") == "1x1"  # canonicalised: a no-op
        assert eng.telemetry.registry.value("mesh_rebinds_total") == 0
        with pytest.raises(ValueError, match="warmed set"):
            cb.set_mesh("2x2")
        assert eng.post_warmup_compiles == 0
        ctl, cb._mesh_ctl = cb._mesh_ctl, None  # a directly built batcher
        with pytest.raises(RuntimeError, match="mesh control surface"):
            cb.set_mesh("1x1")
        cb._mesh_ctl = ctl
        dis = eng.paged_continuous(slots=4, disagg=True)
        with pytest.raises(ValueError, match="cannot rebind"):
            dis.set_mesh("1x1")


def _reqs(vocab: int) -> list:
    rng = np.random.default_rng(5)
    return [Request(rid=i, new_tokens=6, greedy=True, arrival_s=0.0,
                    prompt=tuple(int(x) for x in rng.integers(0, vocab, 12)))
            for i in range(6)]


def _serve(cb, reqs, flip_at=None, to=None) -> dict:
    pending, done, it = list(reqs), [], 0
    while pending or cb.has_work:
        it += 1
        assert it < 200, "stream wedged"
        if it == flip_at:
            assert cb.set_mesh(to) == to
        take = pending[:cb.free_slots]
        del pending[:len(take)]
        if take:
            back = cb.admit(take, now=float(it))  # dense: a count
            pending[:0] = back if isinstance(back, list) else []
        done += cb.step(now=float(it))
    done += cb.flush(float(it))
    return {r.rid: r.tokens for r in done}


@pytest.mark.parametrize("kind, spec_k", [("paged", 0), ("dense", 0),
                                          ("paged", 2), ("dense", 2)])
def test_set_mesh_to_a_warmed_slice_mid_stream(smoke, kind, spec_k):
    """A rebind onto the warmed slice "1x1@1" (a second logical CPU device)
    mid-stream copies the live state into that mesh's storage and flips the
    hot slot (with speculation the draft cache moves too): the tokens equal
    the unflipped stream's, no build, and the lane histograms carry the new
    mesh label."""
    cfg, _ = smoke
    make = "paged_continuous" if kind == "paged" else "continuous"
    with _engine(smoke, meshes=("1x1@1",), devices=("cpu", "cpu"),
                 spec_k=spec_k) as eng:
        want = _serve(getattr(eng, make)(slots=4), _reqs(cfg.vocab_size))
        cb = getattr(eng, make)(slots=4)
        got = _serve(cb, _reqs(cfg.vocab_size), flip_at=3, to="1x1@1")
        assert cb.mesh == "1x1@1"
        assert got == want
        assert eng.telemetry.registry.value("mesh_rebinds_total") == 1
        assert eng.post_warmup_compiles == 0
        hist = eng.telemetry.registry._families["lane_step_ms"].children
        assert any(dict(k).get("mesh") == "1x1@1" for k in hist)
