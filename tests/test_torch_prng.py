"""The port's threefry (``repro_torch.prng``) against ``jax.random``, and
the sampling kernel's wrappers (``repro_torch.kernels.sampling``).

Bit-exact: ``threefry2x32``, ``split``, 8/16/32-bit ``random_bits`` over
random keys and shapes, float32 and bfloat16 ``uniform``. ``gumbel``: the
two ``log``s are the one place where implementations may round
differently (XLA's CPU ``log`` and the port's correctly rounded one are
each within an ulp of the true value), so a float32 gumbel is held to two
ulps of float32 at ``max(|g|, 1)`` (one for each log; below 1 the outer log
of a value near 1 amplifies the inner log's last bit relative to ``g``);
a bfloat16 gumbel takes one of 128 values and must be bit-exact.
``categorical`` and the steps' ``_sample_rows`` against the JAX package's
``repro.runtime.steps._sample_rows`` (mixed temperatures and greedy flags):
tokens and new keys equal at V 512 and 50304 (``categorical`` alone at 512
and 4096); a token may differ only
where JAX's own two best scores lie within one ulp of the score dtype, and
such rows are counted (0 on these inputs).

``cuda``-marked (skipped here): the kernel against its plain version on
the card at the serving shapes. JAX is imported only in the ``jx``
fixture, so those run where JAX is missing.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import kernels, prng
from repro_torch.kernels import sampling
from repro_torch.runtime import steps as tsteps

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TINY = torch.finfo(torch.float32).tiny


@pytest.fixture(scope="module")
def jx():
    """JAX, its threefry primitive and the JAX package's sampler."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax._src import prng as jprng

    from repro.runtime import steps as jsteps

    return SimpleNamespace(
        jax=jax, jnp=jnp, prng=jprng, steps=jsteps,
        dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16},
    )


def _keys(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, 2),
                                                dtype=np.uint32)


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(keys.view(np.int32))


def test_jax_runs_partitionable_threefry(jx):
    """The mode ``prng`` reproduces: a change of JAX default shows here."""
    assert jx.jax.config.jax_threefry_partitionable is True
    assert jx.jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5)])
def test_threefry2x32_matches_jax(jx, shape):
    rng = np.random.default_rng(0)
    k1, k2, x1, x2 = (rng.integers(0, 2**32, size=shape, dtype=np.uint32)
                      for _ in range(4))
    want = jx.jax.jit(lambda *a: jx.prng.threefry2x32_p.bind(*a))(
        k1, k2, x1, x2)
    got = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                              for a in (k1, k2, x1, x2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_split_matches_jax(jx, n):
    jax = jx.jax
    keys = _keys(6, seed=n)
    want = jax.vmap(lambda k: jax.random.split(k, n))(jx.jnp.asarray(keys))
    got = prng.split(_t(keys), n)
    assert got.dtype == torch.int32 and got.shape == (6, n, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("shape", [(1,), (513,), (4, 777)])
def test_random_bits_match_jax(jx, bits, shape):
    jax, jnp = jx.jax, jx.jnp
    keys = _keys(3, seed=bits + len(shape))
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[bits]
    want = jax.vmap(lambda k: jax.random.bits(k, shape, dt))(jnp.asarray(keys))
    got = prng.random_bits(_t(keys), bits, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", [(0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)],
                         ids=["unit", "tiny", "wide"])
def test_uniform_matches_jax(jx, dtype, span):
    jax, jnp = jx.jax, jx.jnp
    keys = _keys(4, seed=1)
    want = jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, (5000,), jx.dtypes[dtype], *span)
    ))(jnp.asarray(keys))
    got = prng.uniform(_t(keys), (5000,), TORCH_DTYPES[dtype], *span)
    assert got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bfloat16_uniform_draws_eight_bits():
    """bfloat16 keeps 7 mantissa bits of the low byte: 128 values."""
    u = prng.uniform(_t(_keys(8, seed=2)), (4096,), torch.bfloat16)
    assert len(torch.unique(u)) == 128 and float(u.max()) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_matches_jax(jx, dtype):
    jax, jnp = jx.jax, jx.jnp
    keys = _keys(8, seed=3)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.gumbel(k, (50304,), jx.dtypes[dtype])
    ))(jnp.asarray(keys)).astype(jnp.float32))
    got = prng.gumbel(_t(keys), (50304,), TORCH_DTYPES[dtype]).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        return
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("vocab", [512, 4096])
def test_categorical_matches_jax(jx, vocab):
    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(vocab)
    keys = _keys(6, seed=4)
    logits = (rng.standard_normal((6, vocab)) * 3).astype(np.float32)
    want = jax.jit(jax.vmap(jax.random.categorical))(jnp.asarray(keys),
                                                     jnp.asarray(logits))
    got = prng.categorical(_t(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one key over every row: the counters run across rows
    want1 = jax.jit(jax.random.categorical)(jnp.asarray(keys[0]),
                                            jnp.asarray(logits))
    got1 = prng.categorical(_t(keys)[0], torch.from_numpy(logits))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def _jax_scores(jx, logits, temps, keys, dtype):
    """JAX's sampled scores (``gumbel + logits / t`` in ``dtype``) per row:
    where the port's token differs, its two best must be a near-tie."""
    jax, jnp = jx.jax, jx.jnp
    jl = jnp.asarray(logits).astype(jx.dtypes[dtype])
    t = jnp.maximum(jnp.asarray(temps), 1e-4)[:, None].astype(jl.dtype)
    halves = jax.vmap(lambda k: jax.random.split(k, 2))(jnp.asarray(keys))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (jl.shape[1],), jl.dtype))(
        halves[:, 0])
    return np.asarray((g + jl / t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [512, 50304])
def test_sample_rows_matches_the_jax_package(jx, dtype, vocab):
    """The steps' tail against ``repro.runtime.steps._sample_rows`` on the
    same logits, temperatures, greedy flags and keys."""
    rng = np.random.default_rng(vocab + len(dtype))
    s = 8
    logits = (rng.standard_normal((s, vocab)) * 4).astype(np.float32)
    temps = np.array([1.0, 0.5, 1.7, 0.0, 1.0, 2.0, 0.3, 1.0], np.float32)
    greedy = np.array([0, 0, 1, 0, 0, 1, 0, 0], bool)
    keys = _keys(s, seed=vocab)
    jax, jnp = jx.jax, jx.jnp
    jl = jnp.asarray(logits).astype(jx.dtypes[dtype])
    jtok, jkeys = jax.jit(jx.steps._sample_rows)(
        jl, jnp.asarray(temps), jnp.asarray(greedy), jnp.asarray(keys))
    ttok, tkeys = tsteps._sample_rows(
        torch.from_numpy(logits).to(TORCH_DTYPES[dtype]),
        torch.from_numpy(temps), torch.from_numpy(greedy), _t(keys))
    np.testing.assert_array_equal(tkeys.numpy().view(np.uint32),
                                  np.asarray(jkeys))
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    eps = float(jnp.finfo(jx.dtypes[dtype]).eps)
    ties = 0
    flipped = np.flatnonzero(ttok != jtok)
    scores = _jax_scores(jx, logits, temps, keys, dtype) if len(flipped) else 0
    for r in flipped:
        assert not greedy[r], r
        a, b = scores[r, jtok[r]], scores[r, ttok[r]]
        assert abs(a - b) <= eps * max(abs(a), 1.0), (r, a, b)
        ties += 1
    assert ties == 0, f"{ties} near-tie flips"
    assert (ttok[greedy] == logits[greedy].argmax(-1)).all()


def test_cpu_wrappers_run_the_plain_versions():
    logits = torch.randn(3, 64)
    temps, greedy = torch.ones(3), torch.tensor([True, False, False])
    keys = _t(_keys(3, seed=9))
    before = kernels.sample_rows.launches
    tok, new_keys = kernels.sample_rows(logits, temps, greedy, keys)
    want = sampling.sample_rows_plain(logits, temps, greedy, keys)
    assert torch.equal(tok, want[0]) and torch.equal(new_keys, want[1])
    one = kernels.categorical_rows(keys[0], logits, 0.7)
    assert torch.equal(one, sampling.categorical_rows_plain(keys[0], logits,
                                                            0.7))
    assert kernels.sample_rows.launches == before
    assert kernels.sample_rows in kernels.KERNELS


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows, vocab", [(8, 50304), (8, 151936), (1, 256000),
                                         (3, 100)])
def test_cuda_sample_rows_matches_plain(cuda, dtype, rows, vocab):
    g = torch.Generator().manual_seed(rows + vocab)
    logits = (torch.randn(rows, vocab, generator=g) * 4).to(
        TORCH_DTYPES[dtype]).to(cuda)
    temps = (torch.rand(rows, generator=g) * 2).to(cuda)
    greedy = (torch.arange(rows) % 3 == 1).to(cuda)
    keys = _t(_keys(rows, seed=vocab)).to(cuda)
    before = kernels.sample_rows.launches
    tok, new_keys = kernels.sample_rows(logits, temps, greedy, keys)
    assert kernels.sample_rows.launches == before + 1
    ptok, pkeys = sampling.sample_rows_plain(logits, temps, greedy, keys)
    assert torch.equal(new_keys, pkeys)
    assert torch.equal(tok, ptok)
    # the workspace is left zeroed: a second launch gives the same
    again, _ = kernels.sample_rows(logits, temps, greedy, keys)
    assert torch.equal(again, tok)
    flat = kernels.categorical_rows(keys[0], logits, 0.8)
    assert torch.equal(flat, sampling.categorical_rows_plain(keys[0], logits,
                                                             0.8))


@pytest.mark.cuda
def test_cuda_sample_rows_reads_a_strided_view_and_refuses_bad_operands(cuda):
    g = torch.Generator().manual_seed(0)
    full = torch.randn(4, 3, 512, generator=g).to(cuda)
    view = full[:, 0]  # the verify lane's row 0: a row stride of 3 * 512
    args = (torch.ones(4, device=cuda), torch.zeros(4, dtype=torch.bool,
                                                     device=cuda),
            _t(_keys(4, seed=1)).to(cuda))
    tok, _ = kernels.sample_rows(view, *args)
    assert torch.equal(tok, sampling.sample_rows_plain(view, *args)[0])
    with pytest.raises(ValueError, match="keys"):
        kernels.sample_rows(view, args[0], args[1], args[2].long())
    with pytest.raises(ValueError, match="unit stride"):
        kernels.sample_rows(full[:, 0, ::2], *args)
