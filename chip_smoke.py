#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

1. Set-up: the card's name and power limit, torch/CUDA versions, and the
   build of the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together, sm_90a).
2. Each kernel against its plain PyTorch version on the card, fp32 and
   bf16: B1/B3 paged decode and B2/B4 paged prefill (B3/B4 over int8 pages
   quantised with the port's ``quantise_kv_rows``) on olmo-1b heads (16/16,
   dh 128, page 16), GQA layouts (40/8 and 32/2, dh 128, page 16) and the
   smoke layout (4/2, dh 16, page 8), window and softcap on and off, ragged
   positions and block tables that share pages and pad with the null page;
   B5 dense decode at the first, a middle and the last row, and B6/B7 flash
   attention over a ragged 200-token sequence in every causal x window x
   softcap mode (B7 from flags), on the same four head layouts, fed the
   model's ``[B, S, H, dh]`` layout as strided views.
3. The serving paths: olmo-1b at full width (bf16, seeded random weights)
   serving a shared-prefix stream through ``run_paged_stream`` with chunked
   prefill — first on bf16 pages (B1/B2), then on int8 pages with
   speculative decoding (k up to 4, a 2-layer int8 draft; B3/B4) — and a
   Poisson stream through the per-burst engine (``run_burst_stream``:
   ``set_mode`` + ``decode_loop``, B5), each with the kernels' launch counts
   set to 0 just before it and every other kernel held at 0 launches.
4. One paged prefill step and one paged decode step at full width with the
   kernels and with the plain attention, on identical inputs, for bf16 and
   int8 pages; the prompt-then-burst path (``prefill`` of 8 prompts of 256
   with B6, ``pad_cache`` to 1024, ``decode_loop`` of 32 greedy tokens with
   B5) held against ``forward`` (B6) over prompt + tokens, and ``forward``
   with B6 against the naive attention; then profiled windows of full-width
   decode steps (bf16 pages), speculative steps (int8 pages) and burst
   steps: device busy vs host wall.
5. The smoke config's greedy stream on the card and on the CPU: plain, and
   with speculation on model-dtype pages (B2 through the verify lane) and on
   int8 pages; the spec streams equal the plain ones.
6. mamba2 (B8): the SSD chunked scan against its plain version on the
   smoke config's heads (chunks 4, 8, 16; S 16, 32 and a ragged 20) and on
   mamba2-370m's (chunk 256; S 1024 and a ragged 1056), fp32 and bf16, with
   B and C as stride-0 views of one group; then mamba2-370m at full width
   (48 layers, bf16, seeded weights): ``prefill`` of 8 prompts of 1024
   (B8), ``pad_cache`` (SSM slots untouched), 32 greedy burst tokens on the
   recurrent state, ``forward`` over the 1056 tokens (B8; exactly 2 x 48
   launches) against the burst's tokens and against ``ssd_scan``, profiled
   prefill and burst steps, and the olmo burst cell's traffic through the
   per-burst engine; the smoke config's greedy burst stream card = CPU.
7. The paper's kernel pair through ``KernelBranch`` (B6 specialised against
   B7 from flags, in the causal, causal + window 256 and causal + softcap 50
   modes, at 8 x 1024 tokens); then kernel timing at the main paths' shapes
   (B4 also at the verify window's, B8 at the mamba2 prefill's): kernel,
   plain version, one PyTorch library call where one exists (a yardstick
   the port never calls) and the bound, and the B7 / B6 time ratio per
   mode.

It prints the card line, a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain, same inputs. fp32: both sum in fp32, in another order ->
# 1e-4. bf16: the plain version runs in fp32 on the same bf16 values, the
# kernel also computes in fp32 but rounds its output to bf16 (relative
# 2^-9, outputs here are |o| < 4) -> 2e-2.
KERNEL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Full-width logits, kernel vs plain attention: the plain tail rounds scores
# and probabilities to bf16 (as the JAX package does), the kernels keep them
# in fp32; 16 bf16 layers amplify that into differences of order 0.1 on
# logits of order 1. (On int8 pages both compute in fp32 and round the
# attention output to bf16, so they agree more closely.)
STEP_LOGIT_ATOL = 0.25
# Near-tie margin: a greedy stream may flip where the top-2 logits of the
# reference run lie closer than this (float reassociation).
TIE_MARGIN = 1e-4
# The same at full width in bf16, where the burst's one-token steps and
# forward's 288-row products round differently in every layer: a flip is a
# near-tie when forward's top logit leads the burst's token by less than the
# bf16 logits tolerance between two attention implementations.
BF16_TIE_MARGIN = STEP_LOGIT_ATOL


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1
def setup() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    build.load()
    info = build.build_info
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", info["log"])]
    libs = ", ".join(Path(x).name for x in info["libraries"])
    log(f"[setup] kernels built and loaded in {info['seconds']:.1f}s from "
        f"{libs}: {len(regs)} kernels, registers "
        f"{min(regs, default=0)}..{max(regs, default=0)}, max spill stores "
        f"{max(spills, default=0)} B")


# ------------------------------------------------------------------ phase 2
def _quantised(pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.models import quantise_kv_rows

    return quantise_kv_rows(pages)


def _kernel_inputs(heads, kv_heads, dh, ps, dtype, *, chunk, seed, int8=False):
    """Ragged rows over a shared pool: row 1 reuses row 0's first pages,
    padding points at the null page 0. With ``int8`` the pages come back as
    (int8 pages, scales) pairs, quantised from the same normals."""
    g = torch.Generator().manual_seed(seed)
    n_pages, pb = 24, 6
    dev = "cuda"
    kp = torch.randn(n_pages, ps, kv_heads, dh, generator=g).to(dev)
    vp = torch.randn(n_pages, ps, kv_heads, dh, generator=g).to(dev)
    if int8:
        kp, vp = _quantised(kp), _quantised(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = torch.tensor([
        [3, 7, 0, 0, 0, 0],
        [3, 7, 9, 11, 0, 0],
        [1, 2, 4, 5, 6, 8],
        [10, 12, 13, 14, 15, 16],
    ], dtype=torch.int32)[:, :pb].contiguous().to(dev)
    if chunk == 0:
        q = torch.randn(4, heads, dh, generator=g).to(dev, dtype)
        pos = torch.tensor([5, 2 * ps + 3, 6 * ps - 1, 4 * ps], dtype=torch.int32)
    else:
        q = torch.randn(4, chunk, heads, dh, generator=g).to(dev, dtype)
        pos = torch.tensor([0, ps + 1, 6 * ps - chunk, 3 * ps - 2],
                           dtype=torch.int32)
    return q, kp, vp, bt, pos.to(dev)


def kernels_vs_plain() -> None:
    from repro_torch import kernels

    # group 16 splits a decode block's query heads over two row tiles
    shapes = {"olmo-1b": (16, 16, 128, 16), "gqa-40/8": (40, 8, 128, 16),
              "gqa-32/2": (32, 2, 128, 16), "smoke": (4, 2, 16, 8)}
    modes = [(None, None), (24, None), (None, 2.0), (24, 2.0)]
    worst = {}
    for kname, fn, plain, chunk, int8 in (
        ("decode", kernels.paged_decode_attention,
         kernels.paged_decode_attention_plain, 0, False),
        ("prefill", kernels.paged_prefill_attention,
         kernels.paged_prefill_attention_plain, 8, False),
        ("decode_int8", kernels.paged_decode_attention_int8,
         kernels.paged_decode_attention_int8_plain, 0, True),
        ("prefill_int8", kernels.paged_prefill_attention_int8,
         kernels.paged_prefill_attention_int8_plain, 8, True),
    ):
        for sname, (h, kh, dh, ps) in shapes.items():
            for dtype in (torch.float32, torch.bfloat16):
                for window, cap in modes:
                    q, kp, vp, bt, pos = _kernel_inputs(
                        h, kh, dh, ps, dtype, chunk=chunk, seed=len(worst),
                        int8=int8,
                    )
                    kw = dict(window=window, softcap=cap)
                    if int8:  # pages are (int8, scales); plain takes them as is
                        pages = (kp[0], vp[0], kp[1], vp[1])
                        out = fn(q, *pages, bt, pos, **kw)
                        ref = plain(q.float(), *pages, bt, pos, **kw)
                    else:
                        out = fn(q, kp, vp, bt, pos, **kw)
                        ref = plain(q.float(), kp.float(), vp.float(), bt, pos,
                                    **kw)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    tag = f"{kname}/{sname}/{str(dtype)[6:]}/w={window}/cap={cap}"
                    worst[tag] = err
                    check(err <= KERNEL_ATOL[dtype],
                          f"{tag}: max abs err {err:.3g} > "
                          f"{KERNEL_ATOL[dtype]}")
    for sname, (h, kh, dh, _) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            worst.update(_dense_cases(f"{sname}/{str(dtype)[6:]}", h, kh, dh,
                                      dtype, seed=len(worst)))
    for dtype in ("float32", "bfloat16"):
        errs = {k: v for k, v in worst.items() if f"/{dtype}" in k}
        log(f"[kernels] {len(errs)} {dtype} cases pass, max abs err "
            f"{max(errs.values()):.3g} (tolerance "
            f"{KERNEL_ATOL[getattr(torch, dtype)]})")


def _dense_cases(tag: str, h: int, kh: int, dh: int, dtype, *, seed: int,
                 seq: int = 200) -> dict:
    """B5 at pos 0, mid and last, B6 and B7 (flags) in every mode, on the
    model's [B, S, H, dh] layout passed as transposed views; the sequence is
    ragged against the kernels' 16-row tiles."""
    from repro_torch import kernels

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, seq, n, dh, generator=g).to("cuda", dtype)
               .transpose(1, 2) for n in (h, kh, kh))
    ref_in = [t.float() for t in (q, k, v)]
    errs = {}

    def held(name: str, out, ref) -> None:
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        errs[f"{name}/{tag}"] = err
        check(err <= KERNEL_ATOL[dtype],
              f"{name}/{tag}: max abs err {err:.3g} > {KERNEL_ATOL[dtype]}")

    for causal in (True, False):
        for window in (None, 48):
            for cap in (None, 30.0):
                mode = f"causal={causal}/w={window}/cap={cap}"
                ref = kernels.flash_attention_plain(
                    *ref_in, causal=causal, window=window, softcap=cap)
                out = kernels.flash_attention(
                    q, k, v, causal=causal, window=window, softcap=cap)
                check(out.transpose(1, 2).is_contiguous(),
                      f"flash/{tag}: output not in the [B, S, H, dh] layout")
                held(f"flash/{mode}", out, ref)
                flags = torch.tensor([int(causal), window or 0, int(cap or 0)],
                                     dtype=torch.int32, device="cuda")
                held(f"branchy/{mode}",
                     kernels.flash_attention_branchy(q, k, v, flags), ref)
    for pos in (0, seq // 2, seq - 1):
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for window, cap in ((None, None), (48, None), (None, 30.0), (48, 30.0)):
            kw = dict(window=window, softcap=cap)
            held(f"dense_decode/pos={pos}/w={window}/cap={cap}",
                 kernels.decode_attention(q[:, :, 0], k, v, p, **kw),
                 kernels.decode_attention_plain(
                     ref_in[0][:, :, 0], *ref_in[1:], p, **kw))
    return errs


# ------------------------------------------------------------------ phase 3
def _launches(label: str, expect: tuple) -> dict:
    """Read the kernels' counts after a path: every kernel in ``expect``
    launched, every other kernel not."""
    from repro_torch import kernels

    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: {name} was not launched on its path")
        else:
            check(n == 0, f"{label}: {name} launched {n} times off its path")
    return launches


def _check_stream(label: str, cfg, reqs, rep: dict) -> None:
    check(rep["finished"] == len(reqs),
          f"{label}: finished {rep['finished']}/{len(reqs)}")
    for r in reqs:
        check(len(r.tokens) == r.new_tokens, f"{label} rid {r.rid}: short stream")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{label} rid {r.rid}: token outside the vocabulary")


def burst_stream(cfg, params, label: str = "burst",
                 expect: tuple = ("decode_attention",)) -> dict:
    """The per-burst engine at full width: Poisson traffic (the paged
    streams' rate), a quarter sampled; every burst pays set_mode, so its
    builds after the stream starts are the distinct (bucket, mode) keys it
    meets. ``expect``: the kernels of the model's decode step (none for
    mamba2, whose recurrent step is plain tensor code)."""
    from repro_torch import kernels
    from repro_torch.runtime.scheduler import poisson_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_burst_stream

    ecfg = EngineConfig(max_len=1024, max_batch=8, batch_quantum=4)
    reqs = poisson_arrivals(16, 20.0, seed=0, tokens_mean=16,
                            tokens_max=ecfg.max_len, sample_frac=0.25,
                            vocab=cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, ecfg) as eng:
        rep = run_burst_stream(eng, reqs)
        keys = list(eng._decode.cache.stats.keys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(label, expect)
    _check_stream(label, cfg, reqs, rep)
    check(rep["compiles_after_warmup"] == len(set(keys)) == len(keys),
          f"{label}: compiles_after_warmup {rep['compiles_after_warmup']} "
          f"for keys {keys}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[stream:{label}] {cfg.name}: {rep['finished']} requests, {rep['tokens']} tokens "
        f"in {wall:.1f}s | {rep['tok_per_s']:.1f} tok/s, latency p50 "
        f"{rep['p50_ms']:.1f} ms p95 {rep['p95_ms']:.1f} ms, ttft p50 "
        f"{rep['ttft_p50_ms']:.1f} ms p95 {rep['ttft_p95_ms']:.1f} ms | "
        f"mode switches {rep['mode_switches']}, hot calls "
        f"{rep['hot_calls']}, compiles_after_warmup "
        f"{rep['compiles_after_warmup']} (keys {[tuple(k[1:]) for k in keys]}),"
        f" rebinds {rep['rebinds']} | peak memory {peak_gb:.2f} GB | "
        f"launches {launches}")
    return launches


def _serve(label: str, cfg, params, ecfg, reqs, expect: tuple) -> tuple:
    """One main path: the kernels' counts set to 0 just before the stream,
    read just after; every kernel in ``expect`` must have launched and no
    other kernel may have."""
    from repro_torch import kernels
    from repro_torch.runtime.kvcache import page_bytes
    from repro_torch.runtime.serve import Engine, run_paged_stream

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, ecfg) as eng:
        rep = run_paged_stream(eng, reqs, slots=8, seed=0)
        pool_gb = (eng.pool_physical_pages * cfg.num_layers * page_bytes(
            ecfg.page_size, cfg.num_kv_heads, cfg.head_dim, ecfg.kv_dtype,
            cfg.dtype) / 1e9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(label, expect)
    check(rep["compiles_after_warmup"] == 0,
          f"{label}: compiles_after_warmup {rep['compiles_after_warmup']}")
    check(rep["prefill_chunks"] > 0, f"{label}: no prefill chunks ran")
    check(rep["kv_dtype"] == ecfg.kv_dtype, f"{label}: pool {rep['kv_dtype']}")
    _check_stream(label, cfg, reqs, rep)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[stream:{label}] {rep['finished']} requests, {rep['tokens']} tokens "
        f"({rep['prompt_tokens']} prompt tokens ingested, "
        f"{rep['shared_prompt_tokens']} shared) in {wall:.1f}s incl. warmup | "
        f"{rep['tok_per_s']:.1f} tok/s, latency p50 {rep['p50_ms']:.1f} ms "
        f"p95 {rep['p95_ms']:.1f} ms, ttft p50 {rep['ttft_p50_ms']:.1f} ms "
        f"p95 {rep['ttft_p95_ms']:.1f} ms | steps {rep['steps']} lanes "
        f"{rep['lane_steps']}, compiles_after_warmup "
        f"{rep['compiles_after_warmup']}, rebinds {rep['rebinds']} | peak "
        f"memory {peak_gb:.2f} GB, KV pool {pool_gb:.3f} GB "
        f"({rep['kv_dtype']}) | launches {launches}")
    log(f"[stream:{label}] host_plan_ms {rep['pipeline']['host_plan_ms']} "
        f"device_wait_ms {rep['pipeline']['device_wait_ms']} "
        f"share_ratio {rep['share_ratio']} bucket_crossings "
        f"{rep['bucket_crossings']} chunk_bucket_crossings "
        f"{rep['chunk_bucket_crossings']} tokens/target step "
        f"{rep.get('tokens_per_target_step')}")
    return rep, launches


def full_width_streams() -> dict:
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import shared_prefix_arrivals
    from repro_torch.runtime.serve import EngineConfig

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"[stream] olmo-1b {n_params / 1e9:.3f}B params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    base = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64)

    def traffic():
        return shared_prefix_arrivals(
            16, 20.0, seed=0, num_prefixes=4, prefix_len=128, tokens_mean=16,
            total_max=base["max_len"], sample_frac=0.25, vocab=cfg.vocab_size,
        )

    _, launches = _serve(
        "bf16", cfg, params, EngineConfig(**base), traffic(),
        ("paged_decode_attention", "paged_prefill_attention"),
    )
    rep8, launches8 = _serve(
        "int8+spec", cfg, params,
        EngineConfig(**base, kv_dtype="int8", spec_k=4, draft_layers=2,
                     draft_kv_dtype="int8"),
        traffic(),
        ("paged_decode_attention_int8", "paged_prefill_attention_int8"),
    )
    check(rep8["lane_steps"]["draft"] > 0 and rep8["lane_steps"]["verify"] > 0,
          f"int8+spec: draft/verify lane steps {rep8['lane_steps']}")
    spec = rep8["spec"]
    log(f"[stream:int8+spec] acceptance rate {spec['acceptance_rate']} "
        f"({spec['accepted_tokens']}/{spec['drafted_tokens']} drafted tokens; "
        f"a 2-layer draft of random weights), k_bucket_crossings "
        f"{spec['k_bucket_crossings']}, lane calls {rep8['lane_calls']}")
    launches.update({k: v for k, v in launches8.items() if "int8" in k})
    launches["decode_attention"] = burst_stream(cfg, params)["decode_attention"]
    return {"launches": launches, "params": params, "cfg": cfg}


# ------------------------------------------------------------------ phase 4
def steps_kernel_vs_plain(cfg, params) -> None:
    from repro_torch import models

    dev = "cuda"
    b, c, ps = 4, 64, 16
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                        dtype=torch.int32).to(dev)
    start = torch.zeros(b, dtype=torch.int32, device=dev)
    length = torch.tensor([64, 50, 33, 64], dtype=torch.int32, device=dev)
    bt = torch.zeros(b, 8, dtype=torch.int32)
    bt[:, :5] = torch.arange(1, 21, dtype=torch.int32).view(b, 5)
    bt = bt.to(dev)
    for kv_dtype in ("fp32", "int8"):
        logits = {}
        for impl in ("kernel", "plain"):
            cache = models.init_paged_cache(cfg, 24, ps, kv_dtype, device=dev)
            lp, cache = models.paged_prefill_step(
                cfg, params, cache, tok, start, bt, length, attn_impl=impl)
            dtok = lp.argmax(-1).to(torch.int32)[:, None]
            ld, _ = models.paged_decode_step(
                cfg, params, cache, dtok, length.clone(), bt, attn_impl=impl)
            logits[impl] = (lp, ld)
        torch.cuda.synchronize()
        pages = "bf16" if kv_dtype == "fp32" else "int8"
        for i, name in enumerate(("prefill", "decode")):
            a, p = logits["kernel"][i], logits["plain"][i]
            check(bool(torch.isfinite(a).all()),
                  f"{name}/{pages}: non-finite logits")
            err = (a - p).abs().max().item()
            agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
            log(f"[steps] {name} on {pages} pages, logits kernel vs plain: max "
                f"abs diff {err:.4f} (tolerance {STEP_LOGIT_ATOL}; |logits| "
                f"max {p.abs().max().item():.2f}), argmax agreement {agree:.2f}")
            check(err <= STEP_LOGIT_ATOL,
                  f"{name}/{pages}: logits differ by {err:.4f}")


def prompt_then_burst(cfg, params) -> dict:
    """``prefill`` (B6) of 8 prompts of 256, ``pad_cache`` to 1024, then
    ``set_mode`` + ``decode_loop`` of 32 greedy tokens (B5) — the JAX
    package's prefill-then-decode sequence — and ``forward`` (B6) over
    prompt + tokens, with the counts set to 0 just before and read after.
    Then ``forward`` with B6 against the naive attention on the same
    tokens, and a profiled window of burst steps."""
    from repro_torch import kernels, models
    from repro_torch.runtime import steps
    from repro_torch.runtime.serve import GREEDY, Engine, EngineConfig

    b, prompt_len, n, max_len = 8, 256, 32, 1024
    g = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=g,
                            dtype=torch.int32).to("cuda")
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    last, cache = steps.make_prefill_fn(cfg)(params, prompts)
    cache = models.pad_cache(cfg, cache, max_len)
    first = last.argmax(-1).to(torch.int32)[:, None]
    with Engine(cfg, params, EngineConfig(max_len=max_len, max_batch=b,
                                          batch_quantum=4)) as eng:
        eng.set_mode(batch=b, sampling=GREEDY)
        toks, cache = eng.decode_loop(cache, first, prompt_len, n)
        seq = torch.cat([prompts, first,
                         torch.from_numpy(toks[:, :-1]).to("cuda")], dim=1)
        logits, _ = models.forward(cfg, params, seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches("prompt+burst",
                             ("flash_attention", "decode_attention"))
        check(launches["flash_attention"] == 2 * cfg.num_layers,
              f"prompt+burst: B6 launched {launches['flash_attention']} "
              f"times, expected one per layer for prefill and for forward")
        check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
        gen = logits[:, prompt_len:].float()  # predicts toks[:, i]
        chosen = torch.from_numpy(toks).to("cuda").long()
        lead = gen.max(-1).values - gen.gather(-1, chosen[..., None])[..., 0]
        flips = int((lead > 0).sum())
        check(bool((lead < BF16_TIE_MARGIN).all()),
              f"prompt+burst: forward's top logit leads the burst's token by "
              f"{lead.max().item():.4f}")
        log(f"[prompt+burst] prefill {b}x{prompt_len} (B6), pad_cache to "
            f"{max_len}, decode_loop {n} greedy tokens (B5), forward over "
            f"{seq.shape[1]} tokens (B6) in {wall:.2f}s: argmax agrees at "
            f"{b * n - flips}/{b * n} generated positions; {flips} flips, "
            f"each a near-tie (max lead {lead.max().item():.4f} < "
            f"{BF16_TIE_MARGIN}; {int(((lead > 0) & (lead < TIE_MARGIN)).sum())}"
            f" under {TIE_MARGIN}) | launches {launches}")
        naive, _ = models.forward(cfg, params, seq, impl="naive")
        err = (logits - naive).abs().max().item()
        agree = (logits.argmax(-1) == naive.argmax(-1)).float().mean().item()
        log(f"[prompt+burst] forward B6 vs naive attention: logits max abs "
            f"diff {err:.4f} (tolerance {STEP_LOGIT_ATOL}; |logits| max "
            f"{naive.abs().max().item():.2f}), argmax agreement {agree:.3f}")
        check(err <= STEP_LOGIT_ATOL, f"forward: B6 vs naive differ by {err}")
        del logits, naive
        exe = eng._current
        tok = torch.from_numpy(toks[:, -1:]).to("cuda")
        pos = torch.tensor(prompt_len + n, dtype=torch.int32, device="cuda")
        gen_ = torch.Generator(device="cuda")
        _profile(f"full-width burst step (dense cache, {b} rows, pos "
                 f"{prompt_len + n})", lambda: exe(cache, tok, pos, gen_), 5,
                 "dense_decode_kernel")
    return launches


def _profile(label: str, run, steps: int, attn_kernel: str) -> None:
    """Device kernel time by name (``torch.profiler``) over ``steps`` calls
    of ``run`` against their host wall time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type.name == "CUDA":
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3 / steps
    busy = sum(by_name.values())
    if busy == 0:
        log(f"[profile] {label}: device time not measured (profiler recorded "
            f"no CUDA kernels); host wall {wall_ms:.2f} ms/step")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if attn_kernel in k)
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%), "
        f"{attn_kernel} {attn:.3f} ms; top kernels: "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


def profile_steps(cfg, params) -> None:
    """Where a full-width step's time goes: a decode step on bf16 pages (8
    slots at position 200, 256-token tables), and a speculative step on
    int8 pages (a 2-layer int8 draft proposing 4 tokens, then a 5-row
    verify with the table at the 64-page cap)."""
    from repro_torch import models
    from repro_torch.runtime import steps as steps_mod

    dev, slots, pb, ps = "cuda", 8, 16, 16
    bt = torch.arange(1, slots * pb + 1, dtype=torch.int32,
                      device=dev).view(slots, pb)
    pos = torch.full((slots,), 200, dtype=torch.int32, device=dev)
    tok = torch.zeros(slots, 1, dtype=torch.int32, device=dev)
    cache = models.init_paged_cache(cfg, slots * pb + 1, ps, device=dev)
    _profile("full-width decode step (bf16 pages, 8 slots, pos 200)",
             lambda: models.paged_decode_step(cfg, params, cache, tok, pos, bt),
             5, "paged_decode_kernel")
    del cache
    k, cap = 4, 64
    dcfg, dparams = models.draft_view(cfg, params, 2)
    draft = steps_mod.make_draft_fn(dcfg, k=k)
    verify = steps_mod.make_paged_verify_fn(cfg)
    dcache = models.init_cache(dcfg, slots, 1024, "int8", device=dev)
    cache8 = models.init_paged_cache(cfg, slots * cap + 1, ps, "int8", device=dev)
    btf = torch.arange(1, slots * cap + 1, dtype=torch.int32,
                       device=dev).view(slots, cap)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    temps = torch.ones(slots, device=dev)
    gen = torch.Generator(device=dev)
    length = torch.full((slots,), k + 1, dtype=torch.int32, device=dev)

    def spec_step():
        drafts, _, _ = draft(dparams, dcache, tok, pos, active)
        window = torch.cat([tok, drafts], dim=1)
        return verify(params, cache8, window, pos, btf, length, temps, active,
                      gen)

    _profile("full-width spec step (int8 pages, draft 2 layers x k 4 + "
             "5-row verify, 8 slots, pos 200)", spec_step, 5,
             "paged_prefill_kernel")


# ------------------------------------------------------------------ phase 5
def _near_tie(cfg, params, seq, kv_dtype: str) -> bool:
    """Top-2 margin of the greedy logits after ``seq`` (one plain chunked
    prefill on the CPU, pages of ``kv_dtype``) is under ``TIE_MARGIN``."""
    from repro_torch import models

    ps = 8
    n = -(-len(seq) // ps)
    cache = models.init_paged_cache(cfg, n + 1, ps, kv_dtype)
    logits, _ = models.paged_prefill_step(
        cfg, params, cache, torch.tensor([seq], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.arange(1, n + 1, dtype=torch.int32)[None],
        torch.tensor([len(seq)], dtype=torch.int32), attn_impl="plain",
    )
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1]) < TIE_MARGIN


def smoke_card_vs_cpu() -> dict:
    """The smoke config (fp32, TF32 off), greedy: card = CPU for the plain
    stream and for speculation on model-dtype and on int8 pages; each spec
    stream equals its pool's plain stream up to a near-tie."""
    from repro_torch import kernels, models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import shared_prefix_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    streams, b2_verify = {}, {}
    for kv_dtype, spec_k in (("fp32", 0), ("fp32", 2), ("int8", 0), ("int8", 2)):
        for dev in ("cuda", "cpu"):
            reqs = shared_prefix_arrivals(
                12, 1000.0, seed=2, num_prefixes=3, prefix_len=20,
                tokens_mean=8, total_max=64, sample_frac=0.0,
                vocab=cfg.vocab_size,
            )
            ecfg = EngineConfig(max_len=64, max_batch=4, page_size=8,
                                num_pages=40, prefill_chunk=16,
                                kv_dtype=kv_dtype, spec_k=spec_k,
                                draft_kv_dtype=kv_dtype)
            kernels.reset_launch_counts()
            with Engine(cfg, params, ecfg, device=dev) as eng:
                rep = run_paged_stream(eng, reqs, slots=4)
                warm_vf = len(eng._k_buckets())
            tag = f"{kv_dtype}/spec_k={spec_k}/{dev}"
            check(rep["finished"] == len(reqs)
                  and rep["compiles_after_warmup"] == 0,
                  f"smoke stream {tag}: {rep['finished']} finished, "
                  f"{rep['compiles_after_warmup']} compiles after warmup")
            if spec_k:
                check(rep["lane_steps"]["verify"] > 0, f"{tag}: no verify")
            if spec_k and kv_dtype == "fp32" and dev == "cuda":
                # B2 serves the pf and vf lanes, one launch per layer per
                # call, warmup's dummy calls included
                n = kernels.paged_prefill_attention.launches
                steps = rep["lane_steps"]
                want = cfg.num_layers * (
                    steps["prefill"] + len(eng._chunk_buckets())
                    + steps["verify"] + warm_vf
                )
                check(n == want, f"{tag}: B2 launched {n}, expected {want}")
                b2_verify = {"launches": cfg.num_layers
                             * (steps["verify"] + warm_vf),
                             "verify_steps": steps["verify"]}
            streams[tag] = {r.rid: (r.prompt, r.tokens) for r in reqs}
    for kv_dtype in ("fp32", "int8"):
        for spec_k in (0, 2):
            a = streams[f"{kv_dtype}/spec_k={spec_k}/cuda"]
            b = streams[f"{kv_dtype}/spec_k={spec_k}/cpu"]
            check(a == b, f"smoke {kv_dtype}/spec_k={spec_k}: card != CPU")
        plain = streams[f"{kv_dtype}/spec_k=0/cpu"]
        spec = streams[f"{kv_dtype}/spec_k=2/cpu"]
        ties = 0
        for rid, (prompt, toks) in plain.items():
            other = spec[rid][1]
            diff = [i for i, (x, y) in enumerate(zip(toks, other)) if x != y]
            if diff:
                check(_near_tie(
                    cfg, params, list(prompt) + toks[:diff[0]], kv_dtype),
                    f"smoke {kv_dtype}: spec stream differs at rid {rid}")
                ties += 1
            else:
                check(toks == other, f"smoke {kv_dtype}: rid {rid} length")
        n = sum(len(t) for _, t in plain.values())
        log(f"[smoke] {kv_dtype} pages, greedy: card = CPU with and without "
            f"speculation; spec = plain stream ({len(plain)} requests, {n} "
            f"tokens, {ties} near-tie divergences)")
    log(f"[smoke] B2 through the verify lane: {b2_verify['launches']} launches "
        f"({b2_verify['verify_steps']} verify steps x {cfg.num_layers} layers, "
        f"warmup included)")
    return b2_verify


# ------------------------------------------------------- phase 6 (mamba2)
# B8 against its plain version, tolerances relative to the largest |output|
# (SSD outputs are sums of up to L decayed terms, not bounded by 1 as
# attention's are). fp32: the same fp32 sums in another order, and the
# chunk's log-decay prefix sum taken by a block scan instead of a
# sequential one (|cum| reaches ~200 over a 256-row chunk, so exp(cum_l -
# cum_l') carries ~1e-5 relative) -> 2e-4. bf16: both round y to bf16
# (relative 2^-8), and may round one element to neighbouring values -> 1e-2.
# The state is fp32 on both sides from the same inputs -> 2e-4 in both types.
SSD_REL_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
SSD_STATE_REL_TOL = 2e-4
# The B8 cases: the smoke config's heads (8 of 16, state 16) at the chunks
# the JAX package's kernel tests use, a ragged 20; and mamba2-370m's (32 of
# 64, state 128, chunk 256) at two rows of 1024 and a ragged 1056.
SSD_CASES = [(2, s, 8, 16, 16, chunk) for chunk in (4, 8, 16)
             for s in (16, 32, 20)] + [(2, s, 32, 64, 128, 256)
                                       for s in (1024, 1056)]


def _ssd_inputs(b, s, h, p, n, dtype, *, seed: int):
    """B8's operands as the SSM mixer hands them over: x a strided view of
    one xBC tensor, B and C its single group as stride-0 views over the
    heads, dt a softplus in fp32, A = -exp(.) per head."""
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=g).to("cuda", dtype)
    x = xbc[..., : h * p].reshape(b, s, h, p)
    bm = xbc[..., h * p : h * p + n].reshape(b, s, 1, n).expand(b, s, h, n)
    cm = xbc[..., h * p + n :].reshape(b, s, 1, n).expand(b, s, h, n)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g)).cuda()
    a = -torch.exp(torch.randn(h, generator=g) * 0.3).cuda()
    return x, bm, cm, dt, a


def _ssd_errs(out, ref) -> tuple[float, float]:
    """Max abs error of y and of the state, each over the largest |ref|."""
    return tuple((o.float() - r.float()).abs().max().item()
                 / r.float().abs().max().item() for o, r in zip(out, ref))


def ssd_vs_plain() -> dict:
    """B8 against ``ssd_chunk_plain`` on the card for every case, fp32 and
    bf16, y and the final state."""
    from repro_torch import kernels

    worst = {}
    for b, s, h, p, n, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, bm, cm, dt, a = _ssd_inputs(b, s, h, p, n, dtype,
                                           seed=len(worst))
            check(bm.stride(2) == 0 and not x.is_contiguous(),
                  "B8 cases: B/C must be stride-0 views, x a strided view")
            out = kernels.ssd_chunk(x, bm, cm, dt, a, chunk=chunk)
            ref = kernels.ssd_chunk_plain(x, bm, cm, dt, a, chunk=chunk)
            torch.cuda.synchronize()
            ey, es = _ssd_errs(out, ref)
            tag = f"L={chunk}/S={s}/P={p}/N={n}/{str(dtype)[6:]}"
            worst[tag] = (ey, es)
            check(ey <= SSD_REL_TOL[dtype] and es <= SSD_STATE_REL_TOL,
                  f"ssd_chunk {tag}: relative max err y {ey:.3g}, state "
                  f"{es:.3g} > {SSD_REL_TOL[dtype]}, {SSD_STATE_REL_TOL}")
    for dtype in ("float32", "bfloat16"):
        errs = {k: v for k, v in worst.items() if k.endswith(dtype)}
        log(f"[ssd] {len(errs)} {dtype} B8 cases pass (ragged S and stride-0 "
            f"B/C included): max relative err y "
            f"{max(e[0] for e in errs.values()):.3g}, state "
            f"{max(e[1] for e in errs.values()):.3g} (tolerance "
            f"{SSD_REL_TOL[getattr(torch, dtype)]}, {SSD_STATE_REL_TOL})")
    return worst


class _VirtualClock:
    """Time moves only by the stream loop's jumps to the next arrival, so a
    stream forms the same bursts on the card and on the CPU."""

    def __init__(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


def mamba_prompt_then_burst(cfg, params) -> dict:
    """mamba2-370m at full width: ``prefill`` of 8 prompts of 1024 through
    B8, ``pad_cache`` (which leaves the SSM slots alone), ``set_mode`` +
    ``decode_loop`` of 32 greedy tokens on the recurrent state, and
    ``forward`` over the 1056 tokens through B8 (a ragged tail), with the
    counts set to 0 just before and read after. Then ``forward`` with B8
    against ``ssd_scan``, and profiled windows of one prefill and one burst
    step."""
    from repro_torch import kernels, models
    from repro_torch.runtime import steps
    from repro_torch.runtime.serve import GREEDY, Engine, EngineConfig

    b, prompt_len, n, max_len = 8, 1024, 32, 1024
    g = torch.Generator().manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=g,
                            dtype=torch.int32).to("cuda")
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    last, cache = steps.make_prefill_fn(cfg)(params, prompts)
    padded = models.pad_cache(cfg, cache, max_len)
    check(all(padded[0][k] is cache[0][k] for k in cache[0]),
          "mamba pad_cache: the SSM slot's cache was not left alone")
    first = last.argmax(-1).to(torch.int32)[:, None]
    with Engine(cfg, params, EngineConfig(max_len=max_len, max_batch=b,
                                          batch_quantum=4)) as eng:
        eng.set_mode(batch=b, sampling=GREEDY)
        toks, cache = eng.decode_loop(padded, first, prompt_len, n)
        seq = torch.cat([prompts, first,
                         torch.from_numpy(toks[:, :-1]).to("cuda")], dim=1)
        logits, _ = models.forward(cfg, params, seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches("mamba prompt+burst", ("ssd_chunk",))
        check(launches["ssd_chunk"] == 2 * cfg.num_layers,
              f"mamba prompt+burst: B8 launched {launches['ssd_chunk']} "
              f"times, expected one per layer for prefill and for forward")
        check(bool(torch.isfinite(logits).all()),
              "mamba forward: non-finite logits")
        gen = logits[:, prompt_len:].float()  # predicts toks[:, i]
        chosen = torch.from_numpy(toks).to("cuda").long()
        lead = gen.max(-1).values - gen.gather(-1, chosen[..., None])[..., 0]
        flips = int((lead > 0).sum())
        check(bool((lead < BF16_TIE_MARGIN).all()),
              f"mamba prompt+burst: forward's top logit leads the burst's "
              f"token by {lead.max().item():.4f}")
        log(f"[mamba prompt+burst] prefill {b}x{prompt_len} (B8), pad_cache "
            f"(SSM slots unchanged), decode_loop {n} greedy tokens on the "
            f"recurrent state, forward over {seq.shape[1]} tokens (B8) in "
            f"{wall:.2f}s: argmax agrees at {b * n - flips}/{b * n} "
            f"generated positions; {flips} flips, each a near-tie (max lead "
            f"{lead.max().item():.4f} < {BF16_TIE_MARGIN}) | launches "
            f"{launches}")
        scan, _ = models.forward(cfg, params, seq, impl="naive")
        err = (logits - scan).abs().max().item()
        agree = (logits.argmax(-1) == scan.argmax(-1)).float().mean().item()
        log(f"[mamba prompt+burst] forward B8 vs ssd_scan: logits max abs "
            f"diff {err:.4f} (tolerance {STEP_LOGIT_ATOL}; |logits| max "
            f"{scan.abs().max().item():.2f}), argmax agreement {agree:.3f}")
        check(err <= STEP_LOGIT_ATOL,
              f"mamba forward: B8 vs ssd_scan differ by {err}")
        del logits, scan
        _profile(f"full-width mamba2 prefill ({b}x{prompt_len}, B8)",
                 lambda: models.prefill(cfg, params, prompts), 2,
                 "ssd_chunk_kernel")
        exe = eng._current
        tok = torch.from_numpy(toks[:, -1:]).to("cuda")
        pos = torch.tensor(prompt_len + n, dtype=torch.int32, device="cuda")
        gen_ = torch.Generator(device="cuda")
        _profile(f"full-width mamba2 burst step ({b} rows, recurrent state)",
                 lambda: exe(cache, tok, pos, gen_), 5, "ssd_chunk_kernel")
    return launches


def mamba_full_width() -> dict:
    """mamba2-370m at full width (48 layers, bf16, seeded weights): the
    prompt-then-burst path through B8, then the olmo burst cell's traffic
    through the per-burst engine on the recurrent state."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"[mamba] mamba2-370m {n_params / 1e9:.3f}B params bf16 initialised "
        f"in {time.perf_counter() - t0:.1f}s")
    launches = mamba_prompt_then_burst(cfg, params)
    burst_stream(cfg, params, "mamba burst", ())
    return launches


def mamba_smoke_card_vs_cpu() -> None:
    """The mamba2 smoke config (fp32, TF32 off), greedy: the burst stream's
    tokens on the card equal the CPU's under one virtual clock."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import poisson_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_burst_stream

    cfg = get_config("mamba2-370m").smoke()
    params = models.init_params(cfg, seed=0)
    streams, reports = {}, {}
    for dev in ("cuda", "cpu"):
        reqs = poisson_arrivals(12, 50.0, seed=4, tokens_mean=8,
                                tokens_max=32, sample_frac=0.0,
                                vocab=cfg.vocab_size)
        with Engine(cfg, params, EngineConfig(max_len=32, max_batch=8,
                                              batch_quantum=4),
                    device=dev) as eng:
            rep = run_burst_stream(eng, reqs, clock=_VirtualClock())
        _check_stream(f"mamba smoke/{dev}", cfg, reqs, rep)
        streams[dev] = {r.rid: r.tokens for r in reqs}
        reports[dev] = {k: rep[k] for k in ("mode_switches", "compiles_total",
                                            "rebinds")}
    check(streams["cuda"] == streams["cpu"] and reports["cuda"] == reports[
        "cpu"], f"mamba smoke burst stream: card != CPU ({reports})")
    log(f"[smoke] mamba2 greedy burst stream: card = CPU "
        f"({len(streams['cpu'])} requests, "
        f"{sum(len(t) for t in streams['cpu'].values())} tokens, "
        f"{reports['cpu']})")


# ------------------------------------------------------------------ phase 7
def _median_ms(fn, runs: int = 30, warmup: int = 5) -> float:
    """Median of per-call CUDA-event times; L2 is flushed before each call
    (the serving loop finds a layer's pages cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(launches: dict, b2_verify: dict) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch import kernels

    dev, dtype = "cuda", torch.bfloat16
    h = kh = 16
    dh, ps, slots, pool = 128, 16, 8, 513
    g = torch.Generator().manual_seed(3)
    kp = torch.randn(pool, ps, kh, dh, generator=g).to(dev)
    vp = torch.randn(pool, ps, kh, dh, generator=g).to(dev)
    (kq, ks), (vq, vs) = _quantised(kp), _quantised(vp)  # the int8 pool
    kp, vp = kp.to(dtype), vp.to(dtype)  # the bf16 pool
    perm = torch.randperm(pool - 1, generator=g) + 1  # distinct live pages

    def bound(kv_tokens: int, pairs: int, q, out, ints, kv_bytes: int):
        """Least time for the call: each visible K/V row read once (and its
        scale, for int8), q read, out written; or its flops at bf16 peak."""
        nbytes = (2 * kv_tokens * kv_bytes + q.numel() * q.element_size()
                  + out.numel() * out.element_size()
                  + sum(t.numel() * 4 for t in ints))
        ops = 4 * dh * pairs  # QK^T and PV, two flops per MAC
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def gathered(pages, bt, length, scale=None):
        """Pages of each row as [B, KH, L, dh] in q's dtype (dequantised
        first for int8) — the library call's inputs, made before timing."""
        g_ = pages[bt[:, : length // ps]].float()
        if scale is not None:
            g_ = g_ * scale[bt[:, : length // ps]][..., None, None]
        return g_.reshape(bt.shape[0], length, kh, dh).transpose(1, 2).to(
            dtype).contiguous()

    def decode_case(int8: bool):
        # B1/B3 at the decode lane's shapes: 8 slots, pages bucket 16
        pb = 16
        bt = perm[: slots * pb].view(slots, pb).to(torch.int32).to(dev)
        pos = torch.randint(96, pb * ps, (slots,), generator=g,
                            dtype=torch.int32).to(dev)
        q = torch.randn(slots, h, dh, generator=g).to(dev, dtype)
        mask = torch.arange(pb * ps, device=dev)[None] <= pos[:, None].long()
        sc = (ks, vs) if int8 else (None, None)
        gk = gathered(kq if int8 else kp, bt, pb * ps, sc[0])
        gv = gathered(vq if int8 else vp, bt, pb * ps, sc[1])
        pages = (kq, vq, ks, vs) if int8 else (kp, vp)
        return (q, *pages, bt, pos), lambda: F.scaled_dot_product_attention(
            q[:, :, None], gk, gv, attn_mask=mask[:, None, None]
        ), int((pos + 1).sum()), int((pos + 1).sum()) * h

    def chunk_case(int8: bool, c: int, start: list, length: int):
        # B2/B4 at the prefill lane's shapes (8 rows x chunk 64) or the
        # verify lane's (8 rows x k+1 = 5); table at the 64-page cap
        pbf = 64
        btf = perm[: slots * pbf].view(slots, pbf).to(torch.int32).to(dev)
        st = torch.tensor(start, dtype=torch.int32, device=dev)
        q = torch.randn(slots, c, h, dh, generator=g).to(dev, dtype)
        sc = (ks, vs) if int8 else (None, None)
        gk = gathered(kq if int8 else kp, btf, length, sc[0])
        gv = gathered(vq if int8 else vp, btf, length, sc[1])
        qi = st[:, None].long() + torch.arange(c, device=dev)[None]
        mask = torch.arange(length, device=dev)[None, None] <= qi[:, :, None]
        pages = (kq, vq, ks, vs) if int8 else (kp, vp)
        pairs = sum(s_ + i + 1 for s_ in start for i in range(c)) * h
        return (q, *pages, btf, st), lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), gk, gv, attn_mask=mask[:, None]
        ), int((st + c).sum()), pairs

    prefill_start = [0, 64, 128, 192, 0, 64, 128, 192]  # keys < 256
    verify_start = [130, 200, 250, 300, 140, 180, 220, 231]  # keys < 320
    bf16_row, int8_row = kh * dh * 2, kh * dh + 4  # bytes per K or V row
    cases = [
        (kernels.paged_decode_attention, kernels.paged_decode_attention_plain,
         "src/repro/kernels/decode_attention.py:322", bf16_row,
         decode_case(False), None),
        (kernels.paged_prefill_attention,
         kernels.paged_prefill_attention_plain,
         "src/repro/kernels/prefill_attention.py:220", bf16_row,
         chunk_case(False, 64, prefill_start, 256), None),
        (kernels.paged_decode_attention_int8,
         kernels.paged_decode_attention_int8_plain,
         "src/repro/kernels/decode_attention.py:346", int8_row,
         decode_case(True), None),
        (kernels.paged_prefill_attention_int8,
         kernels.paged_prefill_attention_int8_plain,
         "src/repro/kernels/prefill_attention.py:253", int8_row,
         chunk_case(True, 64, prefill_start, 256),
         chunk_case(True, 5, verify_start, 320)),
    ]

    def measure(fn, plain, kv_row, case):
        args, library, kv_tokens, pairs = case
        out = fn(*args)
        ref = plain(args[0].float(), *args[1:])
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        check(err <= KERNEL_ATOL[dtype], f"{fn.__name__} at main-path shapes "
              f"q{tuple(args[0].shape)}: max abs err {err:.3g}")
        saved = fn.launches  # timing launches are not main-path launches
        ms = _median_ms(lambda: fn(*args))
        fn.launches = saved
        plain_ms = _median_ms(lambda: plain(*args))
        library_ms = _median_ms(library)
        bound_ms, bound_by = bound(kv_tokens, pairs, args[0], out,
                                   args[-2:], kv_row)
        log(f"[timing] {fn.__name__} bf16 q{tuple(args[0].shape)} pages "
            f"{tuple(args[1].shape)} {args[1].dtype} table "
            f"{tuple(args[-2].shape)}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), max abs err {err:.3g}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    rows = []
    for fn, plain, replaces, kv_row, case, verify in cases:
        source = "src/repro_torch/csrc/" + (
            "paged_attention_int8.cu" if "int8" in fn.__name__
            else "paged_attention.cu")
        row = {"name": fn.__name__, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[fn.__name__],
               **measure(fn, plain, kv_row, case)}
        if verify is not None:  # the same kernel at the verify window
            row.update({f"verify_{k}": v for k, v in
                        measure(fn, plain, kv_row, verify).items()})
        if fn is kernels.paged_prefill_attention:
            row["verify_launches"] = b2_verify["launches"]  # smoke, phase 5
        rows.append(row)
    return rows


# Modes of the kernel pair at the prefill shape: olmo-1b's (causal) and the
# two that a specialisation changes most — a 256-token window (skips tiles)
# and a softcap of 50 (adds a tanh per score).
PAIR_MODES = {"causal": dict(causal=True),
              "causal+window256": dict(causal=True, window=256),
              "causal+softcap50": dict(causal=True, softcap=50.0)}


def _prefill_shape_qkv(seed: int):
    """8 x 1024 tokens, 16 heads of 128, bf16, in the model's [B, S, H, dh]
    layout handed over as [B, H, S, dh] views."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(8, 1024, 16, 128, generator=g).to("cuda", torch.bfloat16)
            .transpose(1, 2) for _ in range(3)]


def kernel_pair() -> dict:
    """The paper's kernel-level comparison as a path: ``KernelBranch``'s
    specialised kernel (B6) and its runtime-flag twin (B7) set to each mode
    and called on the same inputs; counts set to 0 just before."""
    from repro_torch import kernels
    from repro_torch.kernels import KernelBranch

    q, k, v = _prefill_shape_qkv(7)
    spec, branchy = KernelBranch("pair"), KernelBranch("pair", branchy=True)
    kernels.reset_launch_counts()  # this path's run starts here
    errs = {}
    for name, mode in PAIR_MODES.items():
        spec.set_mode(**mode)
        branchy.set_mode(**mode)
        a, b = spec(q, k, v), branchy(q, k, v)
        torch.cuda.synchronize()
        errs[name] = (a.float() - b.float()).abs().max().item()
        check(errs[name] <= KERNEL_ATOL[torch.bfloat16],
              f"kernel pair {name}: B6 and B7 differ by {errs[name]:.3g}")
    launches = _launches("kernel pair",
                         ("flash_attention", "flash_attention_branchy"))
    log(f"[pair] KernelBranch B6 vs B7 at 8x1024, 16 heads of 128, bf16: max "
        f"abs diff per mode {errs} (tolerance {KERNEL_ATOL[torch.bfloat16]}); "
        f"{spec.builds} specialisations built; launches {launches}")
    return launches


def time_dense_kernels(launches: dict) -> list[dict]:
    """B5 at the burst decode shape (8 rows, a 1024-row cache, pos 255) and
    B6/B7 at the prefill shape in each ``PAIR_MODES`` mode: kernel, plain,
    library (SDPA; none computes a softcap) and bound, and B7 / B6."""
    import torch.nn.functional as F

    from repro_torch import kernels

    dtype, dh, h = torch.bfloat16, 128, 16

    def bound(nbytes: int, pairs: int) -> tuple[float, str]:
        t_b = nbytes / HBM_BYTES_PER_S
        t_o = 4 * dh * pairs / PEAK_FLOPS[dtype]  # QK^T and PV
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def timed(fn, call, plain, args, library) -> dict:
        """``call`` runs the wrapper ``fn`` (bound to a mode); timing
        launches are not main-path launches, so ``fn``'s count is kept."""
        out = call(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= KERNEL_ATOL[dtype], f"{fn.__name__} at main-path shapes: "
              f"max abs err {err:.3g}")
        saved = fn.launches
        ms = _median_ms(lambda: call(*args))
        fn.launches = saved
        return {"max_abs_err": err, "ms": ms,
                "plain_ms": _median_ms(lambda: plain(*args)),
                "library_ms": None if library is None else _median_ms(library)}

    rows = []
    # B5: 8 rows at pos 255 of a [8, 1024, 16, 128] cache (transposed view)
    g = torch.Generator().manual_seed(11)
    cache_k, cache_v = (torch.randn(8, 1024, h, dh, generator=g)
                        .to("cuda", dtype).transpose(1, 2) for _ in range(2))
    q1 = torch.randn(8, h, dh, generator=g).to("cuda", dtype)
    pos = torch.tensor(255, dtype=torch.int32, device="cuda")
    mask = (torch.arange(1024, device="cuda") <= 255)[None, None, None]
    m = timed(kernels.decode_attention, kernels.decode_attention,
              kernels.decode_attention_plain, (q1, cache_k, cache_v, pos),
              lambda: F.scaled_dot_product_attention(
                  q1[:, :, None], cache_k, cache_v, attn_mask=mask))
    seen = 256
    b_ms, b_by = bound(2 * 8 * seen * h * dh * 2 + 2 * q1.numel() * 2 + 4,
                       8 * h * seen)
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention.py:97",
                 "launches": launches["decode_attention"], **m,
                 "bound_ms": b_ms, "bound_by": b_by})
    log(f"[timing] decode_attention bf16 q(8, 16, 128) cache (8, 16, 1024, "
        f"128) pos 255: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms,"
        f" sdpa {m['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max "
        f"abs err {m['max_abs_err']:.3g}")
    # B6 / B7 at the prefill shape, one entry per mode
    q, k, v = _prefill_shape_qkv(12)
    s_ = 1024
    per_mode = {"flash_attention": {}, "flash_attention_branchy": {}}
    for name, mode in PAIR_MODES.items():
        window = mode.get("window")
        qi = torch.arange(s_, device="cuda")[:, None]
        ki = torch.arange(s_, device="cuda")[None, :]
        ok = ki <= qi
        if window is not None:
            ok &= ki > qi - window
        pairs = 8 * h * int(ok.sum())
        b_ms, b_by = bound(4 * 8 * s_ * h * dh * 2, pairs)
        if "softcap" in mode:
            library = None
        elif window is None:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True)
        else:
            library = lambda ok=ok: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=ok)
        flags = torch.tensor([1, window or 0, int(mode.get("softcap", 0))],
                             dtype=torch.int32, device="cuda")
        for fn, call, plain, args in (
            (kernels.flash_attention, partial(kernels.flash_attention, **mode),
             partial(kernels.flash_attention_plain, **mode), (q, k, v)),
            (kernels.flash_attention_branchy, kernels.flash_attention_branchy,
             kernels.flash_attention_branchy_plain, (q, k, v, flags)),
        ):
            m = timed(fn, call, plain, args, library)
            per_mode[fn.__name__][name] = {**m, "bound_ms": b_ms,
                                           "bound_by": b_by}
            log(f"[timing] {fn.__name__} bf16 8x1024, 16 heads of 128, "
                f"{name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f}"
                f" ms, sdpa {m['library_ms']} ms, bound {b_ms:.4f} ms "
                f"({b_by}), max abs err {m['max_abs_err']:.3g}")
    ratio = {name: per_mode["flash_attention_branchy"][name]["ms"]
             / per_mode["flash_attention"][name]["ms"] for name in PAIR_MODES}
    log(f"[timing] B7 / B6 time ratio per mode: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items()))
    for fname, replaces in (
        ("flash_attention", "src/repro/kernels/flash_attention.py:112"),
        ("flash_attention_branchy", "src/repro/kernels/flash_attention.py:239"),
    ):
        main = per_mode[fname]["causal"]
        rows.append({"name": fname, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": replaces, "launches": launches[fname],
                     **main, "modes": per_mode[fname],
                     "b7_over_b6": ratio})
    return rows



def time_ssd_kernel(launches: dict) -> list[dict]:
    """B8 at the prefill shape (8 x 1024 tokens, 32 heads of 64, state 128,
    chunk 256, bf16, the mixer's strided and stride-0 operands): kernel,
    plain, no library call (no single PyTorch call computes SSD), and the
    bound from this input's bytes and useful flops."""
    from repro_torch import kernels

    b, s, h, p, n, chunk = 8, 1024, 32, 64, 128, 256
    dtype = torch.bfloat16
    args = _ssd_inputs(b, s, h, p, n, dtype, seed=21)
    out = kernels.ssd_chunk(*args, chunk=chunk)
    ref = kernels.ssd_chunk_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    ey, es = _ssd_errs(out, ref)
    check(ey <= SSD_REL_TOL[dtype] and es <= SSD_STATE_REL_TOL,
          f"ssd_chunk at the prefill shape: relative err y {ey:.3g}, state "
          f"{es:.3g}")
    saved = kernels.ssd_chunk.launches  # timing launches are not the path's
    ms = _median_ms(lambda: kernels.ssd_chunk(*args, chunk=chunk))
    kernels.ssd_chunk.launches = saved
    plain_ms = _median_ms(lambda: kernels.ssd_chunk_plain(*args, chunk=chunk))
    # each input read once (B and C as their one group), each output
    # written once; flops of the causal half of the two L x L products per
    # chunk, the inter-chunk term and the state update (2 per MAC)
    nbytes = (2 * b * s * h * p * 2 + 2 * b * s * n * 2 + b * s * h * 4
              + h * 4 + b * h * p * n * 4)
    ops = 0
    for c0 in range(0, s, chunk):
        r = min(chunk, s - c0)
        ops += 2 * (r * (r + 1) // 2) * (n + p) + 4 * r * p * n
    ops *= b * h
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    bound_ms = max(t_b, t_o) * 1e3
    bound_by = "bytes" if t_b >= t_o else "operations"
    log(f"[timing] ssd_chunk bf16 x({b}, {s}, {h}, {p}) state {n} chunk "
        f"{chunk}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP), relative err y {ey:.3g} state {es:.3g}")
    return [{"name": "ssd_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_chunk.cu",
             "replaces": "src/repro/kernels/ssd_chunk.py:73",
             "launches": launches["ssd_chunk"], "max_abs_err": max(
                 (o.float() - r_.float()).abs().max().item()
                 for o, r_ in zip(out, ref)),
             "max_rel_err": max(ey, es), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    setup()
    kernels_vs_plain()
    main_path = full_width_streams()
    steps_kernel_vs_plain(main_path["cfg"], main_path["params"])
    prompt = prompt_then_burst(main_path["cfg"], main_path["params"])
    profile_steps(main_path["cfg"], main_path["params"])
    del main_path["params"]
    torch.cuda.empty_cache()
    ssd_vs_plain()
    mamba = mamba_full_width()
    torch.cuda.empty_cache()
    b2_verify = smoke_card_vs_cpu()
    mamba_smoke_card_vs_cpu()
    launches = dict(main_path["launches"],
                    flash_attention=prompt["flash_attention"],
                    flash_attention_branchy=kernel_pair()[
                        "flash_attention_branchy"],
                    ssd_chunk=mamba["ssd_chunk"])
    rows = (time_kernels(launches, b2_verify) + time_dense_kernels(launches)
            + time_ssd_kernel(launches))
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
