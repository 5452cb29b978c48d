"""Kernels B1 (paged decode) and B2 (paged prefill) of the port against the
JAX package: their plain versions (what the wrappers run on CPU tensors)
against the Pallas kernels in interpret mode and against the ``*_reference``
oracles, and — on a card — the CUDA kernels against the plain versions; for
the dense kernels B5-B7 (held against the JAX package in
``test_torch_flash.py``) the wrappers' CPU/CUDA split and, on a card, the
CUDA kernels against their plain versions.

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

from repro_torch import kernels, models
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


PLAIN = {
    kernels.paged_decode_attention: kernels.paged_decode_attention_plain,
    kernels.paged_prefill_attention: kernels.paged_prefill_attention_plain,
    kernels.paged_decode_attention_int8: kernels.paged_decode_attention_int8_plain,
    kernels.paged_prefill_attention_int8:
        kernels.paged_prefill_attention_int8_plain,
}


@pytest.mark.parametrize("kernel", list(PLAIN), ids=lambda k: k.__name__)
def test_cpu_tensors_take_the_plain_version_without_a_launch(kernel):
    chunk = CHUNK if "prefill" in kernel.__name__ else 0
    args = [torch.from_numpy(a) for a in _inputs(2, 8, chunk=chunk)]
    if kernel.__name__.endswith("_int8"):  # int8 pages and their scales
        k8, ks = models.quantise_kv_rows(args[1])
        v8, vs = models.quantise_kv_rows(args[2])
        args = [args[0], k8, v8, ks, vs, *args[3:]]
    before = kernel.launches
    torch.testing.assert_close(
        kernel(*args), PLAIN[kernel](*args), atol=0, rtol=0
    )
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


# -------------------------------------------- dense kernels B5, B6 and B7
DENSE_PLAIN = {
    kernels.decode_attention: kernels.decode_attention_plain,
    kernels.flash_attention: kernels.flash_attention_plain,
    kernels.flash_attention_branchy: kernels.flash_attention_branchy_plain,
}


def _dense_args(kernel, dtype=torch.float32, device="cpu"):
    """GQA 4/2, dh 16, a ragged 40-token sequence; B5 at pos 30 over the
    model's [B, S, KH, dh] cache as a [B, KH, S, dh] view; B7 with flags
    (causal, window 24, softcap 3)."""
    rng = np.random.default_rng(1)
    b, s, h, kh, dh = 2, 40, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, dh)).astype(
        np.float32)).to(device, dtype).transpose(1, 2) for n in (h, kh, kh))
    if kernel is kernels.decode_attention:
        return [q[:, :, 0], k, v,
                torch.tensor(30, dtype=torch.int32, device=device)]
    if kernel is kernels.flash_attention_branchy:
        return [q, k, v, torch.tensor([1, 24, 3], dtype=torch.int32,
                                      device=device)]
    return [q, k, v]


@pytest.mark.parametrize("kernel", list(DENSE_PLAIN), ids=lambda k: k.__name__)
def test_dense_cpu_tensors_take_the_plain_version_without_a_launch(kernel):
    args = _dense_args(kernel)
    before = kernel.launches
    torch.testing.assert_close(kernel(*args), DENSE_PLAIN[kernel](*args),
                               atol=0, rtol=0)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kernel", list(DENSE_PLAIN), ids=lambda k: k.__name__)
def test_cuda_dense_kernels_match_plain(cuda, kernel, dtype, atol):
    """As ``test_cuda_kernels_match_plain``: fp32 1e-4, bf16 2e-2."""
    args = _dense_args(kernel, dtype, cuda)
    before = kernel.launches
    out = kernel(*args)
    ref = DENSE_PLAIN[kernel](*[a.float() if a.is_floating_point() else a
                                for a in args])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(DENSE_PLAIN), ids=lambda k: k.__name__)
def test_cuda_dense_wrapper_raises_on_uninstantiated_shape(cuda, kernel):
    args = _dense_args(kernel, torch.float32, cuda)
    args[:3] = [a[..., :8] for a in args[:3]]  # head_dim 8, unit stride kept
    with pytest.raises(ValueError, match="no kernel instantiated"):
        kernel(*args)


# ------------------------------------------------- SSD chunked scan (B8)
def _ssd_args(b, s, h, p, n, chunk, dtype=torch.float32, device="cpu"):
    """B8's operands as the mamba mixer passes them: x a strided view of one
    xBC tensor, B and C one group as stride-0 views over the heads, dt a
    softplus, A negative (held against the JAX package in
    ``test_torch_ssm.py``)."""
    rng = np.random.default_rng(chunk + s)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32)).to(device, dtype)
    x = xbc[..., : h * p].reshape(b, s, h, p)
    bm, cm = (xbc[..., h * p + i * n : h * p + (i + 1) * n].reshape(
        b, s, 1, n).expand(b, s, h, n) for i in (0, 1))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32))).to(device)
    a = -torch.exp(torch.from_numpy(
        rng.standard_normal(h).astype(np.float32) * 0.3)).to(device)
    return x, bm, cm, dt, a


def test_ssd_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _ssd_args(2, 20, 8, 16, 16, 8)
    before = kernels.ssd_chunk.launches
    out = kernels.ssd_chunk(*args, chunk=8)
    ref = kernels.ssd_chunk_plain(*args, chunk=8)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
    assert kernels.ssd_chunk.launches == before


def test_ssd_kernel_source_instantiates_every_listed_shape():
    """Each (chunk, headdim, state) the wrapper accepts is instantiated in
    ``csrc/ssd_chunk.cu`` (and nothing else is)."""
    import re

    from repro_torch.kernels.ssd_chunk import SSD_SHAPES

    src = (build.CSRC / "ssd_chunk.cu").read_text()
    made = {tuple(int(v) for v in m) for m in re.findall(
        r"REPRO_SSD\((\d+), (\d+), (\d+)\);", src)}
    assert made == set(SSD_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 20, 8, 16, 16, 8), (2, 3, 8, 16, 16, 16), (2, 32, 8, 16, 16, 4),
    (1, 300, 32, 64, 128, 256),
])
def test_cuda_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype, rel):
    """Ragged S (also S < chunk), stride-0 B/C. Errors relative to the
    largest |output|: fp32 sums in another order -> 2e-4; bf16 y rounded to
    bf16 on both sides -> 1e-2; the fp32 state -> 2e-4."""
    args = _ssd_args(b, s, h, p, n, chunk, dtype, cuda)
    before = kernels.ssd_chunk.launches
    y, st = kernels.ssd_chunk(*args, chunk=chunk)
    ry, rst = kernels.ssd_chunk_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert kernels.ssd_chunk.launches == before + 1
    assert y.dtype == dtype and y.is_contiguous() and st.dtype == torch.float32
    for out, ref, tol in ((y, ry, rel), (st, rst, 2e-4)):
        err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= tol


@pytest.mark.cuda
def test_cuda_ssd_wrapper_raises_on_uninstantiated_shape_and_h0(cuda):
    from repro_torch.configs import get_config

    args = _ssd_args(2, 16, 8, 16, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="no kernel instantiated"):
        kernels.ssd_chunk(*args, chunk=32)
    cfg = get_config("mamba2-370m").smoke()
    p = {k: v.to(cuda) for k, v in models.layer_params(
        models.init_params(cfg), 0, 0)["ssm"].items()}
    x = torch.zeros(2, 16, cfg.d_model, device=cuda)
    h0 = torch.zeros(2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                     device=cuda)
    before = kernels.ssd_chunk.launches
    with pytest.raises(ValueError, match="zero state"):
        models.ssm_apply(cfg, p, x, h0, impl="kernel")
    assert kernels.ssd_chunk.launches == before
