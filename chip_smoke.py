#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

1. Set-up: the card's name and power limit, torch/CUDA versions, and the
   build of the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
2. Each kernel (B1 paged decode, B2 paged prefill) against its plain
   PyTorch version on the card: olmo-1b heads (16/16, dh 128, page 16), GQA
   layouts (40/8 and 32/2, dh 128, page 16) and the smoke layout (4/2, dh
   16, page 8), fp32 and bf16, window and softcap on and off; ragged
   positions and block tables that share pages and pad with the null page.
3. The main path: olmo-1b at full width (bf16, seeded random weights)
   serving a shared-prefix stream through ``run_paged_stream`` with chunked
   prefill, with the kernels' launch counts set to 0 just before.
4. One paged prefill step and one paged decode step at full width with the
   kernels and with the plain attention, on identical inputs; then a
   profiled window of full-width decode steps (device busy vs host wall).
5. The smoke config's greedy stream on the card and on the CPU.
6. Kernel timing at the main path's shapes: kernel, plain version, one
   PyTorch library call (a yardstick the port never calls) and the bound.

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
# logits of order 1.
STEP_LOGIT_ATOL = 0.25


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
    log(f"[setup] kernels loaded in {info['seconds']:.1f}s from "
        f"{Path(info['library']).name}: {len(regs)} kernels, registers "
        f"{min(regs, default=0)}..{max(regs, default=0)}, max spill stores "
        f"{max(spills, default=0)} B")


# ------------------------------------------------------------------ phase 2
def _kernel_inputs(heads, kv_heads, dh, ps, dtype, *, chunk, seed):
    """Ragged rows over a shared pool: row 1 reuses row 0's first pages,
    padding points at the null page 0."""
    g = torch.Generator().manual_seed(seed)
    n_pages, pb = 24, 6
    dev = "cuda"
    kp = torch.randn(n_pages, ps, kv_heads, dh, generator=g).to(dev, dtype)
    vp = torch.randn(n_pages, ps, kv_heads, dh, generator=g).to(dev, dtype)
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
    for kname, fn, plain, chunk in (
        ("decode", kernels.paged_decode_attention,
         kernels.paged_decode_attention_plain, 0),
        ("prefill", kernels.paged_prefill_attention,
         kernels.paged_prefill_attention_plain, 8),
    ):
        for sname, (h, kh, dh, ps) in shapes.items():
            for dtype in (torch.float32, torch.bfloat16):
                for window, cap in modes:
                    q, kp, vp, bt, pos = _kernel_inputs(
                        h, kh, dh, ps, dtype, chunk=chunk, seed=len(worst)
                    )
                    out = fn(q, kp, vp, bt, pos, window=window, softcap=cap)
                    ref = plain(q.float(), kp.float(), vp.float(), bt, pos,
                                window=window, softcap=cap)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    tag = f"{kname}/{sname}/{str(dtype)[6:]}/w={window}/cap={cap}"
                    worst[tag] = err
                    check(err <= KERNEL_ATOL[dtype],
                          f"{tag}: max abs err {err:.3g} > "
                          f"{KERNEL_ATOL[dtype]}")
    for dtype in ("float32", "bfloat16"):
        errs = {k: v for k, v in worst.items() if f"/{dtype}/" in k}
        log(f"[kernels] {len(errs)} {dtype} cases pass, max abs err "
            f"{max(errs.values()):.3g} (tolerance "
            f"{KERNEL_ATOL[getattr(torch, dtype)]})")


# ------------------------------------------------------------------ phase 3
def full_width_stream() -> dict:
    from repro_torch import kernels, models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import shared_prefix_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"[stream] olmo-1b {n_params / 1e9:.3f}B params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    ecfg = EngineConfig(max_len=1024, max_batch=8, page_size=16,
                        prefill_chunk=64)
    reqs = shared_prefix_arrivals(
        16, 20.0, seed=0, num_prefixes=4, prefix_len=128, tokens_mean=16,
        total_max=ecfg.max_len, sample_frac=0.25, vocab=cfg.vocab_size,
    )
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, ecfg) as eng:
        rep = run_paged_stream(eng, reqs, slots=8, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check(rep["finished"] == len(reqs),
          f"finished {rep['finished']}/{len(reqs)}")
    check(rep["compiles_after_warmup"] == 0,
          f"compiles_after_warmup {rep['compiles_after_warmup']}")
    check(rep["prefill_chunks"] > 0, "no prefill chunks ran")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for r in reqs:
        check(len(r.tokens) == r.new_tokens, f"rid {r.rid}: short stream")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"rid {r.rid}: token outside the vocabulary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[stream] {rep['finished']} requests, {rep['tokens']} tokens "
        f"({rep['prompt_tokens']} prompt tokens ingested, "
        f"{rep['shared_prompt_tokens']} shared) in {wall:.1f}s incl. warmup | "
        f"{rep['tok_per_s']:.1f} tok/s, latency p50 {rep['p50_ms']:.1f} ms "
        f"p95 {rep['p95_ms']:.1f} ms, ttft p50 {rep['ttft_p50_ms']:.1f} ms "
        f"p95 {rep['ttft_p95_ms']:.1f} ms | steps {rep['steps']} "
        f"(decode {rep['lane_steps']['decode']}, prefill "
        f"{rep['lane_steps']['prefill']}), compiles_after_warmup "
        f"{rep['compiles_after_warmup']}, rebinds {rep['rebinds']} | peak "
        f"memory {peak_gb:.2f} GB | launches {launches}")
    log(f"[stream] host_plan_ms {rep['pipeline']['host_plan_ms']} "
        f"device_wait_ms {rep['pipeline']['device_wait_ms']} "
        f"share_ratio {rep['share_ratio']} bucket_crossings "
        f"{rep['bucket_crossings']} chunk_bucket_crossings "
        f"{rep['chunk_bucket_crossings']}")
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
    logits = {}
    for impl in ("kernel", "plain"):
        cache = models.init_paged_cache(cfg, 24, ps, device=dev)
        lp, cache = models.paged_prefill_step(
            cfg, params, cache, tok, start, bt, length, attn_impl=impl)
        dtok = lp.argmax(-1).to(torch.int32)[:, None]
        ld, _ = models.paged_decode_step(
            cfg, params, cache, dtok, length.clone(), bt, attn_impl=impl)
        logits[impl] = (lp, ld)
    torch.cuda.synchronize()
    for i, name in enumerate(("prefill", "decode")):
        a, p = logits["kernel"][i], logits["plain"][i]
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite logits")
        err = (a - p).abs().max().item()
        agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
        log(f"[steps] {name} logits kernel vs plain: max abs diff {err:.4f} "
            f"(tolerance {STEP_LOGIT_ATOL}; |logits| max "
            f"{p.abs().max().item():.2f}), argmax agreement {agree:.2f}")
        check(err <= STEP_LOGIT_ATOL, f"{name}: logits differ by {err:.4f}")


def profile_decode_steps(cfg, params, steps: int = 5) -> None:
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    a few eager steps (8 slots, 256-token tables) — device kernel time by
    name against the host wall time of the same steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models

    dev, slots, pb, ps = "cuda", 8, 16, 16
    cache = models.init_paged_cache(cfg, slots * pb + 1, ps, device=dev)
    bt = torch.arange(1, slots * pb + 1, dtype=torch.int32,
                      device=dev).view(slots, pb)
    pos = torch.full((slots,), 200, dtype=torch.int32, device=dev)
    tok = torch.zeros(slots, 1, dtype=torch.int32, device=dev)
    for _ in range(2):
        models.paged_decode_step(cfg, params, cache, tok, pos, bt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            models.paged_decode_step(cfg, params, cache, tok, pos, bt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type.name == "CUDA":
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3 / steps
    busy = sum(by_name.values())
    if busy == 0:
        log("[profile] decode step: device time not measured (profiler "
            f"recorded no CUDA kernels); host wall {wall_ms:.2f} ms/step")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if "paged_decode_kernel" in k)
    log(f"[profile] full-width decode step (8 slots, pos 200): wall "
        f"{wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%), "
        f"paged_decode_kernel {attn:.3f} ms; top kernels: "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


# ------------------------------------------------------------------ phase 5
def smoke_card_vs_cpu() -> None:
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import shared_prefix_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    streams = {}
    for dev in ("cuda", "cpu"):
        reqs = shared_prefix_arrivals(
            12, 1000.0, seed=2, num_prefixes=3, prefix_len=20, tokens_mean=8,
            total_max=64, sample_frac=0.0, vocab=cfg.vocab_size,
        )
        ecfg = EngineConfig(max_len=64, max_batch=4, page_size=8,
                            num_pages=40, prefill_chunk=16)
        with Engine(cfg, params, ecfg, device=dev) as eng:
            rep = run_paged_stream(eng, reqs, slots=4)
        check(rep["finished"] == len(reqs) and rep["compiles_after_warmup"] == 0,
              f"smoke stream on {dev}: {rep['finished']} finished, "
              f"{rep['compiles_after_warmup']} compiles after warmup")
        streams[dev] = {r.rid: r.tokens for r in reqs}
    same = streams["cuda"] == streams["cpu"]
    n = sum(len(t) for t in streams["cpu"].values())
    log(f"[smoke] fp32 greedy stream, card vs CPU: {len(streams['cpu'])} "
        f"requests, {n} tokens, identical: {same}")
    check(same, "smoke stream differs between the card and the CPU")


# ------------------------------------------------------------------ phase 6
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


def time_kernels(launches: dict) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch import kernels

    dev, dtype = "cuda", torch.bfloat16
    h = kh = 16
    dh, ps, slots, pool = 128, 16, 8, 513
    g = torch.Generator().manual_seed(3)
    kp = torch.randn(pool, ps, kh, dh, generator=g).to(dev, dtype)
    vp = torch.randn(pool, ps, kh, dh, generator=g).to(dev, dtype)
    perm = torch.randperm(pool - 1, generator=g) + 1  # distinct live pages
    elem = kp.element_size()
    rows = []

    def bound(kv_tokens: int, pairs: int, q, out, *ints) -> tuple[float, str]:
        nbytes = (2 * kv_tokens * kh * dh * elem + q.numel() * elem
                  + out.numel() * elem + sum(t.numel() * 4 for t in ints))
        ops = 4 * dh * pairs  # QK^T and PV, two flops per MAC
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    # B1 at the decode lane's shapes: 8 slots, pages bucket 16 (<= 256 tokens)
    pb = 16
    bt = perm[: slots * pb].view(slots, pb).to(torch.int32).to(dev)
    pos = torch.randint(96, pb * ps, (slots,), generator=g,
                        dtype=torch.int32).to(dev)
    q = torch.randn(slots, h, dh, generator=g).to(dev, dtype)
    gk = kp[bt].reshape(slots, pb * ps, kh, dh).transpose(1, 2).contiguous()
    gv = vp[bt].reshape(slots, pb * ps, kh, dh).transpose(1, 2).contiguous()
    mask = (torch.arange(pb * ps, device=dev)[None] <= pos[:, None].long())
    cases = [(
        kernels.paged_decode_attention, kernels.paged_decode_attention_plain,
        (q, kp, vp, bt, pos), "src/repro/kernels/decode_attention.py:322",
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], gk, gv, attn_mask=mask[:, None, None]),
        int((pos + 1).sum()), int((pos + 1).sum()) * h,
    )]
    # B2 at the prefill lane's shapes: 8 rows, chunk 64, table at the cap 64
    c, pbf = 64, 64
    btf = perm[: slots * pbf].view(slots, pbf).to(torch.int32).to(dev)
    start = torch.tensor([0, 64, 128, 192, 0, 64, 128, 192],
                         dtype=torch.int32, device=dev)
    qf = torch.randn(slots, c, h, dh, generator=g).to(dev, dtype)
    L = 256  # keys past start + c - 1 are masked for every row
    gkf = kp[btf[:, : L // ps]].reshape(slots, L, kh, dh).transpose(1, 2)
    gvf = vp[btf[:, : L // ps]].reshape(slots, L, kh, dh).transpose(1, 2)
    gkf, gvf = gkf.contiguous(), gvf.contiguous()
    qi = start[:, None].long() + torch.arange(c, device=dev)[None]
    maskf = torch.arange(L, device=dev)[None, None] <= qi[:, :, None]
    kv_tok = int((start + c).sum())
    pairs = int(sum((int(s) + i + 1) for s in start.tolist() for i in range(c))) * h
    cases.append((
        kernels.paged_prefill_attention, kernels.paged_prefill_attention_plain,
        (qf, kp, vp, btf, start), "src/repro/kernels/prefill_attention.py:220",
        lambda: F.scaled_dot_product_attention(
            qf.transpose(1, 2), gkf, gvf, attn_mask=maskf[:, None]),
        kv_tok, pairs,
    ))
    for fn, plain, args, replaces, library, kv_tokens, pairs in cases:
        out = fn(*args)
        ref = plain(args[0].float(), kp.float(), vp.float(), *args[3:])
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        check(err <= KERNEL_ATOL[dtype], f"{fn.__name__} at main-path shapes: "
              f"max abs err {err:.3g}")
        saved = fn.launches  # timing launches are not main-path launches
        ms = _median_ms(lambda: fn(*args))
        fn.launches = saved
        plain_ms = _median_ms(lambda: plain(*args))
        library_ms = _median_ms(library)
        bound_ms, bound_by = bound(kv_tokens, pairs, args[0], out, *args[3:])
        rows.append({
            "name": fn.__name__, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[fn.__name__],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
        log(f"[timing] {fn.__name__} bf16 q{tuple(args[0].shape)} pages "
            f"{tuple(kp.shape)} table {tuple(args[3].shape)}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), max abs err {err:.3g}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    setup()
    kernels_vs_plain()
    main_path = full_width_stream()
    steps_kernel_vs_plain(main_path["cfg"], main_path["params"])
    profile_decode_steps(main_path["cfg"], main_path["params"])
    del main_path["params"]
    torch.cuda.empty_cache()
    smoke_card_vs_cpu()
    rows = time_kernels(main_path["launches"])
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
