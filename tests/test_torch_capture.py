"""The per-key capture report and the H100 roofline (``capture_analysis``,
``roofline``), against the JAX package's ``hlo_analysis`` and
``roofline``.

- Each warmed key's ``flops`` and ``transcendentals`` (olmo-1b smoke, fp32,
  the JAX weights; the paged engine with speculation, so ``cbp``, ``pf``,
  ``vf``, ``dr`` and ``drp``, and the dense engine's ``cb`` and ``pfd``)
  equal ``analyze_compiled``'s for the same key. Tolerance: exact. Both
  count every product as 2·M·N·K over the key's static extent (the port's
  kernels by their reckoning at the table's full width, as the JAX step
  attends over the gathered table), and the transcendental elements the
  optimised HLO holds: the softmax's exp, the Gumbel draw's two logs per
  logit, one rsqrt per row a norm, one exp per SiLU element (XLA's CPU
  lowering of the logistic), none for a square (a multiply in HLO).
- ``roofline_terms`` is the reference's formula at the H100 constants
  (its collective term at the NVLink rate, 900 GB/s).
- The kernels' reckonings, at the main-path shapes and data ``chip_smoke.py``
  times them at (the same seeded draws), reproduce ``PERF.md`` §6's bound
  column to its printed digits.
- ``--compile-report`` through the launcher writes one entry per warmed
  key, none an error.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.core.telemetry import Telemetry
from repro_torch.runtime.serve import Engine, EngineConfig
from test_torch_faults import jaxpkg, tparams  # noqa: F401 (fixtures)
from test_torch_paged_decode_split import _one_thread  # noqa: F401 (autouse)

ENGINE = dict(max_len=48, batch_quantum=2, max_batch=4, page_size=8,
              num_pages=40, prefill_chunk=16, spec_k=2)


def _reports(telemetry) -> dict:
    return {str(r["key"]): r for r in telemetry.compile_reports}


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_capture_report_equals_the_jax_report_per_key(jaxpkg, tparams,  # noqa: F811
                                                      engine):
    from repro.core.telemetry import Telemetry as JTelemetry

    make = "paged_continuous" if engine == "paged" else "continuous"
    jaxpkg["reset"]()
    jt = JTelemetry(compile_analysis=True)
    with jaxpkg["serve"].Engine(jaxpkg["cfg"], jaxpkg["params"],
                                jaxpkg["serve"].EngineConfig(**ENGINE),
                                telemetry=jt) as jeng:
        getattr(jeng, make)(slots=4)
    tt = Telemetry(compile_analysis=True)
    with Engine(get_config("olmo-1b").smoke(), tparams,
                EngineConfig(**ENGINE), telemetry=tt, device="cpu") as eng:
        getattr(eng, make)(slots=4)
    want, got = _reports(jt), _reports(tt)
    assert sorted(got) == sorted(want)
    lanes = {r["lane"] for r in got.values()}
    assert lanes == ({"cbp", "pf", "vf", "dr", "drp"} if engine == "paged"
                     else {"cb", "pfd", "vfd", "dr", "drp"})
    for key, rep in got.items():
        assert "error" not in rep and "error" not in want[key], key
        assert (rep["flops"], rep["transcendentals"]) == (
            want[key]["flops"], want[key]["transcendentals"]), key
        assert rep["collectives"] == {} and rep["unknown_trip_whiles"] == 0
        assert 0 < rep["kernel_flops"] < rep["flops"]
        assert rep["build_ms"] > 0 and rep["roofline"]["t_collective_s"] == 0


def test_roofline_terms_are_the_reference_formula(jaxpkg, monkeypatch):  # noqa: F811
    from repro import roofline as jroofline

    monkeypatch.setattr(jroofline, "PEAK_FLOPS", 989e12)
    monkeypatch.setattr(jroofline, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jroofline, "LINK_BW", 900e9)  # H100 NVLink
    rng = np.random.default_rng(0)
    for i in range(20):
        rec = {
            "flops_per_device": float(rng.uniform(0, 1e13)),
            "bytes_per_device": float(rng.uniform(0, 1e10)),
            "collective_bytes_per_device": {} if i % 2 else {
                "all-reduce": float(rng.uniform(0, 1e10)),
                "all-gather": float(rng.uniform(0, 1e9))},
            "chips": 1,
            "model_flops": float(rng.uniform(0, 1e13)),
            "min_bytes_global": float(rng.uniform(0, 1e10)),
        }
        want = jroofline.roofline_terms(rec)
        got = roofline.roofline_terms(rec, dtype=torch.bfloat16)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == (v if isinstance(v, str) else pytest.approx(v))
    rec["flops_per_device"] = 5e12  # fp32 takes its own peak
    assert roofline.roofline_terms(rec, dtype=torch.float32)[
        "t_compute_s"] == pytest.approx(5e12 / 67e12)


def _b1_b3_positions() -> tuple:
    """The decode rows' positions of ``chip_smoke.time_kernels``: its
    generator's draws in its order (the pools, the page permutation, then
    each case's positions and queries)."""
    g = torch.Generator().manual_seed(3)
    for _ in range(2):
        torch.randn(513, 16, 16, 128, generator=g)
    torch.randperm(512, generator=g)
    pos1 = torch.randint(96, 256, (8,), generator=g, dtype=torch.int32)
    torch.randn(8, 16, 128, generator=g)  # B1's q
    torch.randn(8, 64, 16, 128, generator=g)  # B2's q
    pos3 = torch.randint(96, 256, (8,), generator=g, dtype=torch.int32)
    return pos1, pos3


def test_kernel_reckonings_reproduce_the_perf_bound_column():
    """PERF.md §6 (NVIDIA H100 80GB HBM3, 700.00 W; bf16, 16 heads of
    128): B1 0.0036, B2 0.0044, B3 0.0019, B4 0.0028 (prefill) and 0.0022
    (verify), B5 0.0050, B6/B7 0.0401, B8 0.0241, sample_rows 0.0012 at
    1980 MHz; all but sample_rows bytes-bound."""
    bf16, h, dh = 2, 16, 128
    row = {"bf16": h * dh * bf16, "int8": h * dh + 4}

    def paged(kv_tokens, pairs, q_elems, ints, kind):
        return roofline.paged_attention_work(
            dh=dh, pairs=pairs, kv_tokens=kv_tokens, kv_row_bytes=row[kind],
            io_bytes=2 * q_elems * bf16 + 4 * ints)

    def fmt(work, **kw):
        ms, by = roofline.bound_ms(work, torch.bfloat16, **kw)
        return f"{ms:.4f}", by

    pos1, pos3 = _b1_b3_positions()
    decode_ints = 8 * 16 + 8  # the 16-page table and the positions
    for pos, kind, want in ((pos1, "bf16", "0.0036"), (pos3, "int8", "0.0019")):
        kv = int((pos + 1).sum())
        assert fmt(paged(kv, kv * h, 8 * h * dh, decode_ints, kind)) == (
            want, "bytes")
    chunk_ints = 8 * 64 + 8  # the table at the 64-page cap, the starts
    prefill_start = [0, 64, 128, 192, 0, 64, 128, 192]
    verify_start = [130, 200, 250, 300, 140, 180, 220, 231]
    for c, start, kind, want in ((64, prefill_start, "bf16", "0.0044"),
                                 (64, prefill_start, "int8", "0.0028"),
                                 (5, verify_start, "int8", "0.0022")):
        kv = sum(s + c for s in start)
        pairs = sum(s + i + 1 for s in start for i in range(c)) * h
        assert fmt(paged(kv, pairs, 8 * c * h * dh, chunk_ints, kind)) == (
            want, "bytes")
    assert fmt(roofline.dense_decode_work(
        rows=8, heads=h, kv_heads=h, dh=dh, seen=256, elt=bf16)) == (
            "0.0050", "bytes")
    causal = 8 * h * (1024 * 1025 // 2)
    assert fmt(roofline.flash_work(batch=8, seq=1024, heads=h, dh=dh,
                                   elt=bf16, pairs=causal)) == (
        "0.0401", "bytes")
    assert fmt(roofline.ssd_chunk_work(batch=8, seq=1024, heads=32,
                                       head_dim=64, state=128, chunk=256,
                                       elt=bf16)) == ("0.0241", "bytes")
    assert fmt(roofline.sample_rows_work(rows=8, vocab=50304, elt=4,
                                         drawn_rows=5),
               clock_hz=1980e6) == ("0.0012", "operations")


def test_compile_report_through_the_launcher(tmp_path, capsys):
    from repro_torch.launch import serve as tlaunch

    path = tmp_path / "reports" / "compile.json"
    rep = tlaunch.main(["--engine", "paged", "--smoke", "--device", "cpu",
                        "--requests", "4", "--prompt-len", "12",
                        "--prefill-chunk", "8", "--max-len", "32",
                        "--meshes", "1x1@1", "--disagg", "--devices",
                        "cpu cpu", "--compile-report", str(path)])
    out = capsys.readouterr().out
    entries = json.loads(path.read_text())
    keys = [e["key"] for e in entries]
    assert len(keys) == len(set(keys)) == rep["compiles_total"] > 0
    assert rep["compiles_after_warmup"] == 0 and rep["migrations"] > 0
    assert {e["lane"] for e in entries} == {"cbp", "pf", "mg"}
    assert all("error" not in e and e["build_ms"] > 0 for e in entries)
    meshes = {e["key"].split("'")[-2] for e in entries}
    assert meshes == {"1x1", "1x1@1"}
    assert f"({len(entries)} keys)" in out and "disagg:" in out
