"""Kernels B1 (paged decode) and B2 (paged prefill) of the port against the
JAX package: their plain versions (what the wrappers run on CPU tensors)
against the Pallas kernels in interpret mode and against the ``*_reference``
oracles, and — on a card — the CUDA kernels against the plain versions.

Inputs are numpy arrays from a seed: GQA groups 1, 2 and 5, page sizes 8 and
16, window and softcap on and off, ragged positions, a page shared by two
rows and tables padded with the null page 0. Tolerance: fp32 on both sides,
summed in another order -> atol = rtol = 1e-5.

JAX is imported inside a fixture, so the tests marked ``cuda`` also run on a
GPU machine without JAX: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build

TOL = 1e-5
GROUPS = (1, 2, 5)
PAGE_SIZES = (8, 16)
MODES = ((None, None), (6, None), (None, 3.0), (6, 3.0))  # (window, softcap)
CHUNK = 5


def _inputs(group: int, ps: int, *, chunk: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, kh, dh, n_pages = 3, 2, 16, 11
    h = kh * group
    kp = rng.standard_normal((n_pages, ps, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, kh, dh)).astype(np.float32)
    # page 3 is shared by rows 0 and 1; row 0 pads with the null page
    bt = np.array([[3, 1, 0, 0], [5, 3, 7, 2], [8, 9, 10, 4]], np.int32)
    if chunk == 0:
        q = rng.standard_normal((b, h, dh)).astype(np.float32)
        pos = np.array([ps + 1, 3 * ps + 2, 2 * ps - 1], np.int32)
    else:
        q = rng.standard_normal((b, chunk, h, dh)).astype(np.float32)
        pos = np.array([0, 2 * ps + 3, ps + 2], np.int32)
    return q, kp, vp, bt, pos


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel modules (Pallas kernels and oracles)."""
    jnp = pytest.importorskip("jax.numpy")
    dec = importlib.import_module("repro.kernels.decode_attention")
    pre = importlib.import_module("repro.kernels.prefill_attention")

    def run(fn, args, **kw):
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))

    return dec, pre, run


def _torch(fn, args, **kw):
    return fn(*(torch.from_numpy(a) for a in args), **kw).numpy()


@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("group", GROUPS)
def test_decode_plain_matches_pallas_and_reference(
    jref, group, ps, window, softcap
):
    jdec, _, run = jref
    args = _inputs(group, ps, chunk=0, seed=group * ps)
    kw = dict(window=window, softcap=softcap)
    out = _torch(kernels.paged_decode_attention, args, **kw)
    pallas = run(jdec.paged_decode_attention, args, interpret=True, **kw)
    ref = run(jdec.paged_decode_attention_reference, args, **kw)
    np.testing.assert_allclose(out, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window,softcap", MODES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("group", GROUPS)
def test_prefill_plain_matches_pallas_and_reference(
    jref, group, ps, window, softcap
):
    _, jpre, run = jref
    args = _inputs(group, ps, chunk=CHUNK, seed=group * ps + 1)
    kw = dict(window=window, softcap=softcap)
    out = _torch(kernels.paged_prefill_attention, args, **kw)
    pallas = run(jpre.paged_prefill_attention, args, interpret=True, **kw)
    ref = run(jpre.paged_prefill_attention_reference, args, **kw)
    np.testing.assert_allclose(out, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_prefill_chunk_of_one_is_decode():
    """A one-token chunk at ``start`` is a decode at ``pos = start``: the
    packed [C*G] row layout must reduce to the decode layout exactly."""
    q, kp, vp, bt, pos = _inputs(5, 8, chunk=1, seed=7)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, pos)]
    pre = kernels.paged_prefill_attention(*args, window=6)
    args[0] = args[0][:, 0]
    dec = kernels.paged_decode_attention(*args, window=6)
    torch.testing.assert_close(pre[:, 0], dec, atol=0, rtol=0)


@pytest.mark.parametrize("kernel", kernels.KERNELS, ids=lambda k: k.__name__)
def test_cpu_tensors_take_the_plain_version_without_a_launch(kernel):
    chunk = CHUNK if kernel is kernels.paged_prefill_attention else 0
    args = [torch.from_numpy(a) for a in _inputs(2, 8, chunk=chunk)]
    plain = (
        kernels.paged_prefill_attention_plain if chunk
        else kernels.paged_decode_attention_plain
    )
    before = kernel.launches
    torch.testing.assert_close(kernel(*args), plain(*args), atol=0, rtol=0)
    assert kernel.launches == before


def test_library_lands_in_the_build_dir_keyed_by_source_hash():
    path = build.library_path()
    assert path.parent.name == "repro_torch" and path.parent.parent.name == "build"
    assert path.name.startswith("libpaged_attention-") and path.suffix == ".so"
    assert path == build.library_path()  # deterministic for one tree


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
def test_cuda_kernels_match_plain(cuda, group, window, softcap, dtype, atol):
    """fp32: same sums, another order -> 1e-4. bf16: the kernel rounds its
    fp32 result to bf16; the plain version runs in fp32 -> 2e-2."""
    for kernel, plain, chunk in (
        (kernels.paged_decode_attention, kernels.paged_decode_attention_plain, 0),
        (kernels.paged_prefill_attention, kernels.paged_prefill_attention_plain,
         CHUNK),
    ):
        q, kp, vp, bt, pos = (
            torch.from_numpy(a).to(cuda)
            for a in _inputs(group, 16, chunk=chunk, seed=group)
        )
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        before = kernel.launches
        out = kernel(q, kp, vp, bt, pos, window=window, softcap=softcap)
        ref = plain(q.float(), kp.float(), vp.float(), bt, pos,
                    window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_uninstantiated_shape(cuda):
    q, kp, vp, bt, pos = (
        torch.from_numpy(a).to(cuda) for a in _inputs(1, 8, chunk=0)
    )
    with pytest.raises(ValueError, match="no kernel instantiated"):
        kernels.paged_decode_attention(
            q[..., :8].contiguous(), kp[..., :8].contiguous(),
            vp[..., :8].contiguous(), bt, pos,
        )
