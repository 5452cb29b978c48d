"""Serving entry point of the port: a request stream through the paged engine
or the per-burst engine.

``--engine paged`` (default) synthesises open-loop Poisson traffic —
shared-prefix prompts by default, distinct prompts with ``--prompt-len`` —
and drives it through ``Engine.paged_continuous``; ``--kv-dtype int8``
stores the pool as int8 pages (kernels B3/B4) and ``--spec-k K`` turns on
speculative decoding with a ``--draft-layers``-deep draft. ``--engine
burst`` drives prompt-less Poisson traffic through ``run_burst_stream``
(``set_mode`` + ``decode_loop``, kernel B5 for attention stacks): one
sampling mode per burst, batch sizes bucketed by ``--batch-quantum``; it
also serves ``--arch mamba2-370m`` on the SSM's recurrent state (the paged
engine refuses an SSM arch). Both report latency
percentiles, TTFT, throughput and cold-path activity (builds after warmup,
rebinds; for burst, mode switches). Weights are a seeded random init. Runs
on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --arch olmo-1b --requests 16 --rate 50 --tokens-mean 16 \\
      --max-len 1024 --page-size 16 --prefix-len 128 --prefill-chunk 64 \\
      --kv-dtype int8 --spec-k 4 --draft-layers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --engine burst --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --engine burst
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.runtime.scheduler import (
    attach_distinct_prompts,
    poisson_arrivals,
    shared_prefix_arrivals,
)
from repro_torch.runtime.kvcache import KV_DTYPES
from repro_torch.runtime.serve import (
    Engine,
    EngineConfig,
    run_burst_stream,
    run_paged_stream,
)

SLOTS = 8  # continuous-batching slots, as in the JAX package's launcher

_REPORT_KEYS = (
    "compiles_total", "compiles_after_warmup", "rebinds", "slots", "steps",
    "occupancy", "prefill_chunk", "prefill_chunks", "chunk_bucket_crossings",
    "h2d_uploads", "kv_dtype", "pool_pages", "pages_in_use_peak",
    "peak_concurrent", "share_ratio", "overcommit_ratio", "preemptions",
    "bucket_crossings", "cow_copies", "spec_k", "k_bucket_crossings",
    "mode_switches", "hot_calls",
)


def _print_report(rep: dict) -> None:
    tag = f"[serve/{rep['engine']}]"
    head = (
        f"{tag} {rep.get('finished', 0)} requests, "
        f"{rep.get('tokens', 0)} tokens on {rep['device']}"
    )
    if "p50_ms" in rep:
        head += (
            f" | latency p50 {rep['p50_ms']:.1f}ms p95 {rep['p95_ms']:.1f}ms "
            f"p99 {rep['p99_ms']:.1f}ms | {rep['tok_per_s']:.0f} tok/s"
        )
    if "ttft_p95_ms" in rep:
        head += (
            f" | ttft p50 {rep['ttft_p50_ms']:.1f}ms "
            f"p95 {rep['ttft_p95_ms']:.1f}ms"
        )
    print(head, flush=True)
    cold = {k: rep[k] for k in _REPORT_KEYS if k in rep}
    print(f"{tag} {cold}", flush=True)
    if "lane_steps" in rep:
        print(f"{tag} lanes: {rep['lane_steps']} "
              f"pipeline: {rep.get('pipeline')}", flush=True)
    if "spec" in rep:
        print(f"{tag} specdec: {rep['spec']} tokens/target step "
              f"{rep.get('tokens_per_target_step')}", flush=True)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("paged", "burst"), default="paged",
                    help="serving engine: paged continuous batching, or the "
                         "per-burst engine (mode baked into each burst's "
                         "branch target)")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (fp32, 2 layers)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--tokens-mean", type=float, default=8.0,
                    help="mean decode length (geometric)")
    ap.add_argument("--sample-frac", type=float, default=0.5,
                    help="fraction of requests that sample (vs greedy)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--batch-quantum", type=int, default=4,
                    help="burst batch sizes round up to a multiple of this")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool pages (0 = 8 slots x max-len worth)")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared prompt prefix length")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="give every request its own random prompt of this "
                         "length instead of a shared prefix")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max prompt tokens ingested per step (0 = token-by-"
                         "token teacher forcing)")
    ap.add_argument("--kv-dtype", choices=KV_DTYPES, default="fp32",
                    help="page storage: fp32 = the model dtype, int8 = int8 "
                         "pages with per-row scales")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="max draft depth of speculative decoding (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="depth of the truncated-layer draft, in layer "
                         "periods")
    ap.add_argument("--draft-kv-dtype", choices=KV_DTYPES, default="fp32",
                    help="storage of the draft's dense cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object on stdout")
    args = ap.parse_args(argv)
    if args.rate <= 0:
        ap.error(f"--rate must be > 0 requests/s, got {args.rate}")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1, got {args.requests}")
    if args.spec_k < 0:
        ap.error(f"--spec-k must be >= 0, got {args.spec_k}")
    if args.engine == "burst":
        # the per-burst stream seeds first_token only and has no lanes
        # besides its decode (there is no step pipeline to overlap either)
        if args.prompt_len > 0:
            ap.error("--prompt-len requires --engine paged (the burst "
                     "stream does not ingest prompts)")
        if args.spec_k > 0:
            ap.error("--spec-k requires --engine paged (the burst stream "
                     "has no draft/verify lanes)")
        if args.kv_dtype != "fp32":
            ap.error("--kv-dtype requires --engine paged (the dense cache "
                     "has no page pool to quantise)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.engine == "paged":
        try:
            models.check_paged(cfg)
        except ValueError as e:
            ap.error(f"--engine paged: {e}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    params = models.init_params(cfg, seed=args.seed, device=device)
    ecfg = EngineConfig(
        max_len=args.max_len,
        batch_quantum=args.batch_quantum,
        max_batch=SLOTS,
        page_size=args.page_size,
        num_pages=args.num_pages,
        prefill_chunk=args.prefill_chunk,
        kv_dtype=args.kv_dtype,
        spec_k=args.spec_k,
        draft_layers=args.draft_layers,
        draft_kv_dtype=args.draft_kv_dtype,
    )
    if args.engine == "burst":
        reqs = poisson_arrivals(
            args.requests, args.rate, seed=args.seed,
            tokens_mean=args.tokens_mean, tokens_max=args.max_len,
            sample_frac=args.sample_frac, vocab=cfg.vocab_size,
        )
    elif args.prompt_len > 0:
        reqs = poisson_arrivals(
            args.requests, args.rate, seed=args.seed,
            tokens_mean=args.tokens_mean,
            tokens_max=max(1, args.max_len - args.prompt_len),
            sample_frac=args.sample_frac, vocab=cfg.vocab_size,
        )
        attach_distinct_prompts(
            reqs, args.prompt_len, vocab=cfg.vocab_size, seed=args.seed + 1
        )
    else:
        reqs = shared_prefix_arrivals(
            args.requests, args.rate, seed=args.seed,
            num_prefixes=3, prefix_len=args.prefix_len,
            tokens_mean=args.tokens_mean, total_max=args.max_len,
            sample_frac=args.sample_frac, vocab=cfg.vocab_size,
        )
    with Engine(cfg, params, ecfg, device=device) as eng:
        if args.engine == "burst":
            rep = run_burst_stream(eng, reqs, seed=args.seed)
        else:
            rep = run_paged_stream(eng, reqs, seed=args.seed)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        _print_report(rep)
    return rep


if __name__ == "__main__":
    main()
