"""int8 KV pages in the port against the JAX package (DESIGN.md §12).

* ``quantise_kv_rows`` writes the JAX package's bits: int8 values and f32
  scales compared exactly.
* Kernels B3 (paged decode) and B4 (paged prefill, also the verify lane's
  kernel) over int8 pages: their plain versions (what the wrappers run on
  CPU tensors) against the Pallas kernels in interpret mode and against the
  ``*_int8_reference`` oracles, for GQA groups 1/2/5, pages 8/16, every
  window/softcap mode, a shared page and null-page padding. fp32 on both
  sides, summed in another order -> atol = rtol = 1e-5. On a card, the CUDA
  kernels against the plain versions (marked ``cuda``).
* ``paged_prefill_step`` / ``paged_decode_step`` on an int8 pool at the
  smoke config (fp32, where the int8 dtype rule is exactly the JAX
  arithmetic): logits within 1e-5, written pages and scales compared.
* The greedy int8 stream equals the JAX package's int8 stream; scales ride
  copy-on-write and are overwritten after trim and reallocation; a pool
  dtype outside the warmed set raises; ``page_bytes`` prices bf16 pages.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels, models
from repro_torch.runtime.kvcache import BlockTable, PagePool, page_bytes
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

TOL = 1e-5
LOGIT_TOL = 1e-5
GROUPS = (1, 2, 5)
PAGE_SIZES = (8, 16)
MODES = ((None, None), (6, None), (None, 3.0), (6, 3.0))  # (window, softcap)
CHUNK = 5


@pytest.fixture(scope="module")
def jax_mods():
    """The JAX package's attention, kernel and model modules."""
    jax = pytest.importorskip("jax")
    names = ("repro.models.attention", "repro.kernels.decode_attention",
             "repro.kernels.prefill_attention", "repro.models",
             "repro.configs")
    return jax, {n: importlib.import_module(n) for n in names}


@pytest.fixture(scope="module")
def smoke(jax_mods):
    """The olmo-1b smoke config (fp32) on identical weights in both packages."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax

    jax, mods = jax_mods
    cfg = mods["repro.configs"].get_config("olmo-1b").smoke()
    jparams = mods["repro.models"].init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, get_config("olmo-1b").smoke(), jparams, tparams


# ------------------------------------------------------------- quantisation
@pytest.mark.parametrize("case", ["normal", "wide", "zeros_and_halves"])
def test_quantise_kv_rows_writes_the_jax_bits(jax_mods, case):
    jax, mods = jax_mods
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 4, 16)).astype(np.float32)
    if case == "wide":
        x *= rng.uniform(1e-4, 1e3, size=(5, 7, 1, 1)).astype(np.float32)
    elif case == "zeros_and_halves":
        x[0] = 0.0  # all-zero rows: the 1e-8 scale floor
        x[1] = np.round(x[1] * 4) / 4  # many values on rounding ties
        x[1, :, 0, 0] = 127.0 / 4  # absmax pins the scale to 0.25
    jq, js = mods["repro.models.attention"].quantise_kv_rows(jax.numpy.asarray(x))
    tq, ts = models.quantise_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        models.dequantise_kv_rows(tq, ts).numpy(),
        np.asarray(mods["repro.models.attention"].dequantise_kv_rows(jq, js)),
    )


# ---------------------------------------------------------- kernels B3, B4
def _int8_inputs(group: int, ps: int, *, chunk: int, seed: int = 0):
    """q, int8 pages, their scales, block tables, positions — numpy."""
    rng = np.random.default_rng(seed)
    b, kh, dh, n_pages = 3, 2, 16, 11
    h = kh * group
    k = rng.standard_normal((n_pages, ps, kh, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kh, dh)).astype(np.float32)
    kq, ks = (t.numpy() for t in models.quantise_kv_rows(torch.from_numpy(k)))
    vq, vs = (t.numpy() for t in models.quantise_kv_rows(torch.from_numpy(v)))
    # page 3 is shared by rows 0 and 1; row 0 pads with the null page
    bt = np.array([[3, 1, 0, 0], [5, 3, 7, 2], [8, 9, 10, 4]], np.int32)
    if chunk == 0:
        q = rng.standard_normal((b, h, dh)).astype(np.float32)
        pos = np.array([ps + 1, 3 * ps + 2, 2 * ps - 1], np.int32)
    else:
        q = rng.standard_normal((b, chunk, h, dh)).astype(np.float32)
        pos = np.array([0, 2 * ps + 3, ps + 2], np.int32)
    return q, kq, vq, ks, vs, bt, pos


def _run_jax(jax, fn, args, **kw):
    return np.asarray(fn(*(jax.numpy.asarray(a) for a in args), **kw))


@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_plain_matches_pallas_and_reference(
    jax_mods, kind, group, ps, window, softcap
):
    jax, mods = jax_mods
    if kind == "decode":
        jmod = mods["repro.kernels.decode_attention"]
        port, pallas, oracle = (
            kernels.paged_decode_attention_int8,
            jmod.paged_decode_attention_int8,
            jmod.paged_decode_attention_int8_reference,
        )
        args = _int8_inputs(group, ps, chunk=0, seed=group * ps)
    else:
        jmod = mods["repro.kernels.prefill_attention"]
        port, pallas, oracle = (
            kernels.paged_prefill_attention_int8,
            jmod.paged_verify_attention_int8,  # the verify lane's alias
            jmod.paged_prefill_attention_int8_reference,
        )
        args = _int8_inputs(group, ps, chunk=CHUNK, seed=group * ps + 1)
    kw = dict(window=window, softcap=softcap)
    out = port(*(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_allclose(
        out, _run_jax(jax, pallas, args, interpret=True, **kw), atol=TOL, rtol=TOL
    )
    np.testing.assert_allclose(
        out, _run_jax(jax, oracle, args, **kw), atol=TOL, rtol=TOL
    )


def test_int8_plain_equals_model_dtype_plain_on_dequantised_pages():
    """B3/B4's plain versions are B1/B2's bodies on dequantised pages."""
    q, kq, vq, ks, vs, bt, pos = (
        torch.from_numpy(a) for a in _int8_inputs(2, 8, chunk=CHUNK, seed=3)
    )
    dk, dv = models.dequantise_kv_rows(kq, ks), models.dequantise_kv_rows(vq, vs)
    torch.testing.assert_close(
        kernels.paged_prefill_attention_int8(q, kq, vq, ks, vs, bt, pos, window=6),
        kernels.paged_prefill_attention(q, dk, dv, bt, pos, window=6),
        atol=0, rtol=0,
    )


# ------------------------------------------------------- model-level steps
def _step_inputs(cfg):
    rng = np.random.default_rng(3)
    b, c = 3, 8
    return dict(
        tok=rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32),
        start=np.array([0, 8, 3], np.int32),
        length=np.array([8, 5, 0], np.int32),  # row 2 idle, row 1 padded
        # rows 0 and 1 share page 1; row 2 is all null
        bt=np.array([[1, 2, 0, 0], [1, 4, 5, 0], [0, 0, 0, 0]], np.int32),
        dtok=rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
        pos=np.array([8, 13, 0], np.int32),
    )


def _assert_int8_pages_match(jcache, tcache):
    """Pages beyond the null page: int8 values and scales as JAX wrote them.
    A K/V row computed in another summation order may land on the other
    side of a rounding tie, so an int8 value may differ by 1 (never more),
    and the dequantised rows agree to a tenth of a quantisation step."""
    for s, slot in enumerate(tcache):
        j = {k: np.asarray(v)[:, 1:] for k, v in jcache[s].items()}
        t = {k: v[:, 1:].numpy() for k, v in slot.items()}
        assert set(j) == set(t) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(t[name], j[name], rtol=1e-6, atol=0)
        for name, sc in (("k", "k_scale"), ("v", "v_scale")):
            diff = np.abs(t[name].astype(np.int32) - j[name].astype(np.int32))
            assert diff.max() <= 1, (s, name)
            assert (diff > 0).mean() < 1e-3, (s, name, (diff > 0).mean())


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_int8_prefill_then_decode_match_jax(smoke, attn_impl):
    import jax.numpy as jnp
    from repro import models as jm

    cfg, tcfg, jparams, tparams = smoke
    x = _step_inputs(cfg)
    n_pages, ps = 12, 8
    jcache = jm.init_paged_cache(cfg, n_pages, ps, "int8")
    tcache = models.init_paged_cache(tcfg, n_pages, ps, "int8")
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}

    jl, jcache = jm.paged_prefill_step(
        cfg, jparams, jcache, j["tok"], j["start"], j["bt"], j["length"]
    )
    tl, tcache = models.paged_prefill_step(
        tcfg, tparams, tcache, t["tok"], t["start"], t["bt"], t["length"],
        attn_impl=attn_impl,
    )
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    _assert_int8_pages_match(jcache, tcache)

    jl, jcache = jm.paged_decode_step(
        cfg, jparams, jcache, j["dtok"], j["pos"], j["bt"]
    )
    tl, tcache = models.paged_decode_step(
        tcfg, tparams, tcache, t["dtok"], t["pos"], t["bt"], attn_impl=attn_impl,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    _assert_int8_pages_match(jcache, tcache)


def test_int8_residual_stream_keeps_the_model_dtype(smoke):
    """The int8 dtype rule at bf16 (where the JAX package's int8 path cannot
    trace): attention runs in f32, its output returns to bf16 before wo, so
    the step runs and its logits agree with the bf16 model-dtype pool."""
    import dataclasses

    _, tcfg, _, tparams = smoke
    cfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    p16 = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
    x = {k: torch.from_numpy(v) for k, v in _step_inputs(cfg16).items()}
    out = {}
    for dt in ("fp32", "int8"):
        cache = models.init_paged_cache(cfg16, 12, 8, dt)
        _, cache = models.paged_prefill_step(
            cfg16, p16, cache, x["tok"], x["start"], x["bt"], x["length"]
        )
        out[dt], _ = models.paged_decode_step(
            cfg16, p16, cache, x["dtok"], x["pos"], x["bt"]
        )
    assert torch.isfinite(out["int8"]).all()
    # quantisation error (a half step per element) well under the logits'
    # bf16 resolution at this size
    torch.testing.assert_close(out["int8"], out["fp32"], atol=5e-2, rtol=0)


# --------------------------------------------------------------- streams
def _reqs(vocab: int, n=3, prompt_len=12, new_tokens=5):
    rng = np.random.default_rng(0)
    return [
        Request(rid=i, new_tokens=new_tokens, greedy=True, arrival_s=0.0,
                prompt=tuple(int(x) for x in rng.integers(0, vocab, prompt_len)))
        for i in range(n)
    ]


ENGINE = dict(max_len=32, max_batch=4, page_size=8, num_pages=20,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_int8_engine(smoke):
    """The JAX package's int8 engine, once a module (a second
    ``run_paged_stream`` re-warms from its compiled keys)."""
    from repro.core import reset_entry_points
    from repro.runtime import serve as jserve

    cfg, _, jparams, _ = smoke
    reset_entry_points()
    jeng = jserve.Engine(cfg, jparams, jserve.EngineConfig(
        batch_quantum=2, kv_dtype="int8", **ENGINE))
    yield jeng
    jeng.close()


def test_int8_stream_matches_jax_int8_stream(smoke, jax_int8_engine):
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    cfg, tcfg, jparams, tparams = smoke
    jreqs = [jsched.Request(rid=r.rid, new_tokens=r.new_tokens, greedy=True,
                            arrival_s=0.0, prompt=r.prompt)
             for r in _reqs(cfg.vocab_size)]
    jrep = jserve.run_paged_stream(jax_int8_engine, jreqs, slots=4)
    treqs = _reqs(cfg.vocab_size)
    with Engine(tcfg, tparams, EngineConfig(kv_dtype="int8", **ENGINE),
                device="cpu") as eng:
        trep = run_paged_stream(eng, treqs, slots=4)
    assert trep["kv_dtype"] == jrep["kv_dtype"] == "int8"
    assert trep["finished"] == jrep["finished"] == 3
    assert trep["compiles_after_warmup"] == 0
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]


def test_int8_sampled_stream_matches_jax_int8_stream(smoke, jax_int8_engine):
    """Four requests on int8 pages (``cbp``/``pf``), two of them sampled at
    temperatures 0.7 and 1.3: every token equals the JAX engine's (the
    batcher's threefry keys, seeded 4, split in every step)."""
    from repro.runtime import scheduler as jsched
    from repro.runtime import serve as jserve

    cfg, tcfg, _, tparams = smoke
    temps = {1: 0.7, 3: 1.3}

    def reqs(cls):
        return [cls(rid=r.rid, new_tokens=8, greedy=r.rid not in temps,
                    temperature=temps.get(r.rid, 1.0), arrival_s=0.0,
                    prompt=r.prompt)
                for r in _reqs(cfg.vocab_size, n=4)]

    jreqs, treqs = reqs(jsched.Request), reqs(Request)
    jserve.run_paged_stream(jax_int8_engine, jreqs, slots=4, seed=4)
    with Engine(tcfg, tparams, EngineConfig(kv_dtype="int8", **ENGINE),
                device="cpu") as eng:
        trep = run_paged_stream(eng, treqs, slots=4, seed=4)
    assert trep["finished"] == 4 and trep["compiles_after_warmup"] == 0
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]


def test_kv_dtype_outside_the_warmed_set_raises(smoke):
    _, tcfg, _, tparams = smoke
    with Engine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu") as eng:
        with pytest.raises(ValueError, match="kv_dtype='int8' is not in the warmed"):
            eng.paged_continuous(slots=4, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        models.init_paged_cache(tcfg, 5, 8, "fp8")


def test_warmed_dtypes_serve_both_pools_without_builds(smoke):
    """With both dtypes warmed, a pool on either is a rebind: the second
    batcher builds nothing, and a target refuses the other dtype's cache."""
    _, tcfg, _, tparams = smoke
    ecfg = EngineConfig(kv_dtypes=("int8",), **ENGINE)
    with Engine(tcfg, tparams, ecfg, device="cpu") as eng:
        rep = run_paged_stream(eng, _reqs(tcfg.vocab_size), slots=4)
        built = eng._decode.stats.misses
        rep8 = run_paged_stream(eng, _reqs(tcfg.vocab_size), slots=4,
                                kv_dtype="int8")
        assert eng._decode.stats.misses == built
        assert (rep["kv_dtype"], rep8["kv_dtype"]) == ("fp32", "int8")
        step = eng._build(("cbp", 4, 1, "int8", "1x1"))
        z = torch.zeros
        with pytest.raises(ValueError, match="torch.int8"):
            step(models.init_paged_cache(tcfg, eng.pool_physical_pages, 8),
                 z(4, 1, dtype=torch.int32), z(4, dtype=torch.int32),
                 z(4, 1, dtype=torch.int32), z(4, dtype=torch.bool),
                 torch.ones(4), torch.ones(4, dtype=torch.bool),
                 z(4, 2, dtype=torch.int32))


# ------------------------------------------------- scales ride the pages
def test_scale_cow_on_fork(smoke):
    """After fork + ensure_writable the private copy carries the original
    page's int8 bits and its scales: copy_cache_pages moves every leaf."""
    _, tcfg, _, _ = smoke
    pool = PagePool(6, 4, kv_dtype="int8")
    cache = models.init_paged_cache(tcfg, 7, 4, "int8")
    for slot in cache:
        for t in slot.values():
            t[:, 1] = torch.randint(-100, 100, t[:, 1].shape).to(t.dtype)
    copies = []

    def copy_page(src: int, dst: int) -> None:
        copies.append((src, dst))
        models.copy_cache_pages(cache, src, dst)

    table = BlockTable(pool=pool)
    assert table.append_page()  # page 1
    table.num_tokens = 2
    fork = table.fork()
    assert pool.refcount(1) == 2
    assert fork.ensure_writable(2, copy_page)  # the fork writes position 2
    assert copies and copies[0][0] == 1
    dst = copies[0][1]
    for slot in cache:
        assert set(slot) == {"k", "v", "k_scale", "v_scale"}
        for t in slot.values():
            torch.testing.assert_close(t[:, dst], t[:, 1], atol=0, rtol=0)
    fork.release()
    table.release()
    pool.check()


def test_scale_overwrite_after_trim_and_realloc(smoke):
    """trim() releases a page; the next owner's first write overwrites the
    stale int8 bits and the stale scale in one step."""
    _, tcfg, _, tparams = smoke
    ps = 4
    pool = PagePool(2, ps, kv_dtype="int8")
    cache = models.init_paged_cache(tcfg, 3, ps, "int8")
    table = BlockTable(pool=pool)
    assert table.ensure_capacity(ps)  # 2 pages
    bt = torch.zeros(1, 2, dtype=torch.int32)
    bt[0, : table.num_pages] = torch.tensor(table.pages, dtype=torch.int32)
    for i in range(ps + 1):  # rows 0..ps, spilling into the second page
        models.paged_decode_step(
            tcfg, tparams, cache, torch.tensor([[7]], dtype=torch.int32),
            torch.tensor([i], dtype=torch.int32), bt,
        )
    second = table.pages[1]
    stale = cache[0]["k_scale"][0, second].clone()
    assert stale[0] > 0  # the spilled row wrote a real scale
    assert table.trim(1) == 1 and pool.pages_free == 1  # the rollback
    other = BlockTable(pool=pool)
    assert other.append_page() and other.pages[0] == second
    models.paged_decode_step(
        tcfg, tparams, cache, torch.tensor([[9]], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([[second, 0]], dtype=torch.int32),
    )
    fresh = cache[0]["k_scale"][0, second]
    assert fresh[0] != stale[0]  # overwritten, not reused
    torch.testing.assert_close(fresh[1:], stale[1:])  # others masked by pos
    other.release()
    table.release()
    pool.check()


# ------------------------------------------------------------- page cost
def test_page_bytes_prices_model_dtype_pages():
    ps, kh, dh = 16, 16, 128
    f32 = page_bytes(ps, kh, dh, "fp32", model_dtype="float32")
    bf16 = page_bytes(ps, kh, dh, "fp32", model_dtype="bfloat16")
    i8 = page_bytes(ps, kh, dh, "int8", model_dtype="bfloat16")
    assert f32 == 2 * ps * kh * dh * 4 and bf16 == 2 * ps * kh * dh * 2
    assert i8 == 2 * ps * kh * dh + 2 * ps * 4
    assert i8 == page_bytes(ps, kh, dh, "int8")  # int8 is model-independent
    assert 0.5 < i8 / bf16 < 0.51  # a bf16 model's int8 page: about half


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("group", GROUPS)
def test_cuda_int8_kernels_match_plain(cuda, group, window, softcap, dtype, atol):
    """fp32: same sums, another order -> 1e-4. bf16 q: the kernel rounds its
    fp32 result to bf16; the plain version runs in fp32 -> 2e-2."""
    for kernel, plain, chunk in (
        (kernels.paged_decode_attention_int8,
         kernels.paged_decode_attention_int8_plain, 0),
        (kernels.paged_prefill_attention_int8,
         kernels.paged_prefill_attention_int8_plain, CHUNK),
    ):
        q, kq, vq, ks, vs, bt, pos = (
            torch.from_numpy(a).to(cuda)
            for a in _int8_inputs(group, 16, chunk=chunk, seed=group)
        )
        q = q.to(dtype)
        before = kernel.launches
        out = kernel(q, kq, vq, ks, vs, bt, pos, window=window, softcap=softcap)
        ref = plain(q.float(), kq, vq, ks, vs, bt, pos,
                    window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("group", GROUPS)
def test_cuda_int8_decode_kernel_over_splits_and_edge_positions(
    cuda, group, ps, window, softcap, dtype, atol
):
    """B3's cluster-split body at every S 1-8 (empty splits included) on
    the ragged rows and at pos 0, a page's last slot and the table's last
    key, one launch per call; tolerances as above."""
    q, kq, vq, ks, vs, bt, pos = _int8_inputs(group, ps, chunk=0, seed=group + ps)
    for positions in (pos, np.array([0, ps - 1, 4 * ps - 1], np.int32)):
        args = [torch.from_numpy(a).to(cuda)
                for a in (q, kq, vq, ks, vs, bt, positions)]
        args[0] = args[0].to(dtype)
        kw = dict(window=window, softcap=softcap)
        ref = kernels.paged_decode_attention_int8_plain(
            args[0].float(), *args[1:], **kw)
        for splits in range(1, 9):
            before = kernels.paged_decode_attention_int8.launches
            out = kernels.paged_decode_attention_int8(*args, splits=splits, **kw)
            torch.cuda.synchronize()
            assert kernels.paged_decode_attention_int8.launches == before + 1
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.cuda
def test_cuda_int8_wrapper_raises_on_bad_scales(cuda):
    q, kq, vq, ks, vs, bt, pos = (
        torch.from_numpy(a).to(cuda) for a in _int8_inputs(1, 8, chunk=0)
    )
    with pytest.raises(ValueError, match="scales must be float32"):
        kernels.paged_decode_attention_int8(q, kq, vq, ks.double(), vs, bt, pos)
    with pytest.raises(ValueError, match="int8 pages"):
        kernels.paged_decode_attention_int8(q, kq.float(), vq, ks, vs, bt, pos)
