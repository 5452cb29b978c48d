"""Serving entry point of the port: a request stream through the paged
engine, the dense continuous engine or the per-burst engine.

``--engine paged`` (default) synthesises open-loop Poisson traffic —
``--num-prefixes`` shared prefixes by default, distinct prompts with
``--prompt-len``, drawn as the JAX package's launcher draws them —
and drives it through ``Engine.paged_continuous``; ``--kv-dtype int8``
stores the pool as int8 pages (kernels B3/B4) and ``--spec-k K`` turns on
speculative decoding with a ``--draft-layers``-deep draft. ``--engine
continuous`` drives Poisson traffic (distinct prompts with
``--prompt-len``) through ``run_continuous_stream``: ``--slots`` slots of
one dense cache, lanes ``cb``/``pfd``/``vfd`` (kernels B1/B2 over the
cache's page view), speculation with ``--spec-k``; an SSM arch decodes
through ``cb`` with prompts forced token by token. ``--engine burst``
drives prompt-less Poisson traffic through ``run_burst_stream``
(``set_mode`` + ``decode_loop``, kernel B5 for attention stacks): one
sampling mode per burst, batch sizes bucketed by ``--batch-quantum``; it
also serves ``--arch mamba2-370m`` on the SSM's recurrent state (the paged
engine refuses an SSM arch). ``--engine both`` runs the continuous engine
and then the burst engine on the same prompt-less stream, the JAX
package's default; ``--engine all`` runs the continuous, burst and paged
engines in turn. ``--engine overload`` drives Poisson traffic through
``run_overload_stream``, the overload-hardened paged stream: a bounded
admission queue (``--capacity``, ``--shed-policy``, ``--queue-ttl``),
per-request deadlines (``--deadline``), the degradation ladder
(``--degrade``: spec off, the minimum chunk, a trimmed budget, then new
admissions on a pre-warmed int8 pool) and deterministic fault injection at
five sites (``--chaos-seed``: ``FaultPlan.random``). ``--trace-out PATH``
turns the flight recorder on and writes a Chrome trace-event file
(ui.perfetto.dev), ``--metrics-out PATH`` the metrics registry (Prometheus
text for ``.prom``, JSON otherwise), ``--compile-report PATH`` one JSON
entry per warmed key (``capture_analysis``: flops, bytes, transcendentals,
the kernels' share, the capture ms and the key's H100 roofline terms).
``--async-steps`` (``--async-depth``) pipelines the continuous and paged
engines' steps. ``--mesh`` and ``--meshes`` name the active and standby
serving meshes (DESIGN.md §16: "1x1", slices "1x1@OFF" and, for the
paged engine, plans of several devices such as "1x2" and "2x2") over
``--devices`` (space-separated; default each visible device of
``--device``'s type; ``--mesh 1x2 --meshes "1x1 2x2" --devices "cuda:0
cuda:0 cuda:0 cuda:0"`` serves tensor- and data-parallel on one card), and ``--disagg [SLICE]`` pins the paged
engine's prefill lanes to a slice (DESIGN.md §17; default the slice right
after the decode mesh's devices), which ``--meshes`` must list:
``--devices "cuda:0 cuda:0"`` runs both slices on one card. ``--arch`` names any config of
``repro_torch.configs``: olmo-1b, qwen3-14b, gemma2-27b, hft-demo,
deepseek-67b (dense), granite-moe-1b-a400m and grok-1-314b (MoE),
mamba2-370m (SSM) and jamba-1.5-large-398b (hybrid: attention and mamba
layers; the paged engine refuses it, as any stack with a mamba layer). The
embeddings-input archs internvl2-1b and musicgen-medium are refused: a
stream feeds sampled ids back, and they have no token embedding table.
Each reports latency percentiles, TTFT, throughput and cold-path
activity (builds after warmup, rebinds; for burst, mode switches; on the
card every build is a CUDA-graph capture, and
``cuda_graphs`` says the targets were graphs). Weights are a seeded random
init. Runs on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --arch olmo-1b --requests 16 --rate 50 --tokens-mean 16 \\
      --max-len 1024 --page-size 16 --prefix-len 128 --prefill-chunk 64 \\
      --kv-dtype int8 --spec-k 4 --draft-layers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --arch olmo-1b --requests 16 --rate 20 --tokens-mean 16 \\
      --max-len 1024 --prompt-len 128 --prefill-chunk 64 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --engine both --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --engine burst
  PYTHONPATH=src python -m repro_torch.launch.serve --engine overload \\
      --smoke --device cpu --degrade --chaos-seed 7 --trace-out t.json \\
      --metrics-out m.prom
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --smoke --device cpu --prompt-len 24 --prefill-chunk 8 \\
      --meshes 1x1@1 --disagg --devices "cpu cpu" --compile-report r.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.core.telemetry import Telemetry
from repro_torch.runtime.admission import SHED_POLICIES
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
    run_continuous_stream,
    run_overload_stream,
    run_paged_stream,
)
from repro_torch.runtime.tracing import write_trace

SLOTS = 8  # the engine's max_batch, as in the JAX package's launcher

_REPORT_KEYS = (
    "cuda_graphs", "compiles_total", "compiles_after_warmup", "rebinds", "slots", "steps",
    "occupancy", "prefill_chunk", "prefill_chunks", "chunk_bucket_crossings",
    "h2d_uploads", "kv_dtype", "pool_pages", "pages_in_use_peak",
    "peak_concurrent", "share_ratio", "overcommit_ratio", "preemptions",
    "bucket_crossings", "cow_copies", "spec_k", "k_bucket_crossings",
    "mode_switches", "hot_calls", "mesh", "pool_shards",
)


_HARDENING_KEYS = (
    "capacity", "shed_policy", "shed", "cancelled", "failed",
    "deadline_missed", "stragglers", "preemptions", "unserved",
    "degrade_rung",
)


def _print_report(rep: dict) -> None:
    tag = f"[serve/{rep['engine']}]"
    head = (f"{tag} {rep.get('finished', 0)} requests, "
            f"{rep.get('tokens', 0)} tokens")
    if "device" in rep:
        head += f" on {rep['device']}"
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
    if rep.get("disagg"):  # the prefill/decode split (DESIGN.md §17)
        print(f"{tag} disagg: prefill_slice={rep['disagg']} "
              f"migrations={rep.get('migrations', 0)} "
              f"migrated_pages={rep.get('migrated_pages', 0)} "
              f"rebinds={rep.get('disagg_rebinds', 0)}", flush=True)
    if "spec" in rep:
        print(f"{tag} specdec: {rep['spec']} tokens/target step "
              f"{rep.get('tokens_per_target_step')}", flush=True)
    if rep["engine"] == "overload":  # hardening surfaces (DESIGN.md §15)
        hard = {k: rep[k] for k in _HARDENING_KEYS if rep.get(k) is not None}
        print(f"{tag} hardening: {hard}", flush=True)
        if rep.get("degrade_transitions"):
            print(f"{tag} ladder: {rep['degrade_transitions']}", flush=True)
        if rep.get("faults"):
            print(f"{tag} faults: {rep['faults']}", flush=True)
    if rep.get("robustness"):  # registry-derived accounting (DESIGN.md §15)
        print(f"{tag} robustness: {rep['robustness']}", flush=True)


def make_requests(args: argparse.Namespace, vocab: int,
                  engine: str | None = None) -> list:
    """The request stream of the parsed flags for ``engine`` (default
    ``--engine``), drawn as the JAX package's launcher draws it: Poisson
    traffic for the continuous, burst and overload engines, distinct
    prompts with ``--prompt-len``, and shared prefixes for the paged engine
    otherwise. New tokens are capped at ``max_len - max(prompt_len, 1) +
    1``: the batchers seat ``prompt + new - 1 <= max_len`` positions. With
    ``--deadline`` (overload) each request's queue TTL is the deadline and
    its absolute deadline is its arrival plus the deadline."""
    engine = engine or args.engine
    if engine == "paged" and args.prompt_len <= 0:
        return shared_prefix_arrivals(
            args.requests, args.rate, seed=args.seed,
            num_prefixes=args.num_prefixes, prefix_len=args.prefix_len,
            tokens_mean=args.tokens_mean, total_max=args.max_len,
            sample_frac=args.sample_frac, vocab=vocab,
        )
    reqs = poisson_arrivals(
        args.requests, args.rate, seed=args.seed,
        tokens_mean=args.tokens_mean,
        tokens_max=max(1, args.max_len - max(args.prompt_len, 1) + 1),
        sample_frac=args.sample_frac, vocab=vocab,
    )
    if args.prompt_len > 0:
        attach_distinct_prompts(
            reqs, args.prompt_len, vocab=vocab, seed=args.seed + 1
        )
    if engine == "overload" and args.deadline > 0:
        for r in reqs:
            r.ttl_s = args.deadline
            r.deadline_s = r.arrival_s + args.deadline
    return reqs


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The launcher's flags, checked against the engine they name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine",
                    choices=("paged", "continuous", "burst", "overload",
                             "both", "all"),
                    default="paged",
                    help="serving engine: paged continuous batching, dense "
                         "continuous batching, the per-burst engine (mode "
                         "baked into each burst's branch target), the "
                         "overload-hardened paged stream, both the "
                         "continuous and the burst engine on one stream, or "
                         "all of continuous, burst and paged")
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
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous-batching slots (0 = the engine's "
                         f"max_batch, {SLOTS})")
    ap.add_argument("--batch-quantum", type=int, default=2,
                    help="burst batch sizes round up to a multiple of this "
                         "(2, the value the JAX package's launcher fixes)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool pages (0 = 8 slots x max-len worth)")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared prompt prefix length")
    ap.add_argument("--num-prefixes", type=int, default=3,
                    help="number of distinct shared prefixes")
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
    ap.add_argument("--async-steps", action="store_true",
                    help="pipelined step loop (DESIGN.md §13): the host "
                         "plans and issues step N+1 before it commits step "
                         "N, whose outputs stay on the device; the pulls "
                         "land at the token-emit boundaries. The token "
                         "streams equal the synchronous loop's (continuous "
                         "and paged engines)")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="async step pipeline: issued-but-uncommitted "
                         "steps at most (2 = one ahead)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="overload engine: bounded admission-queue "
                         "capacity (0 = unbounded; DESIGN.md §15)")
    ap.add_argument("--shed-policy", choices=SHED_POLICIES,
                    default="reject-new",
                    help="overload engine: what to drop when the bounded "
                         "queue is full")
    ap.add_argument("--queue-ttl", type=float, default=0.0,
                    help="overload engine: shed requests that waited in "
                         "queue longer than this many seconds (0 = off)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="overload engine: per-request SLO in seconds — "
                         "bounds queue wait (ttl) and sets the absolute "
                         "decode deadline past which a seated request is "
                         "cancelled (0 = off)")
    ap.add_argument("--degrade", action="store_true",
                    help="overload engine: the semi-static degradation "
                         "ladder (spec off -> chunk-min -> budget-trim -> "
                         "int8 pool), rebinds over warmed keys, never a "
                         "build")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="overload engine: arm FaultPlan.random(SEED) — "
                         "deterministic fault injection across the five "
                         "sites, with detection/containment accounting in "
                         "the report")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="turn the flight recorder on (DESIGN.md §14) and "
                         "write a Chrome trace-event JSON file, openable in "
                         "ui.perfetto.dev — one track per lane plus "
                         "dispatcher / scheduler / page-pool tracks")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot after the "
                         "run: Prometheus text exposition if PATH ends in "
                         ".prom, JSON otherwise")
    ap.add_argument("--compile-report", default=None, metavar="PATH",
                    help="write a per-DispatchKey capture report (capture "
                         "ms, flops/bytes/transcendentals counted on one "
                         "eager run at the key's shapes, the kernels' "
                         "share, H100 roofline terms) as JSON")
    ap.add_argument("--mesh", default="1x1",
                    help="serving mesh 'DPxMP[@OFF]' (DESIGN.md §16) — "
                         "data x model over --devices' entries [OFF, OFF + "
                         "DP*MP), which may all name one card — a warmed "
                         "dispatch coordinate. Plans of more than one "
                         "device serve --engine paged (dense family, "
                         "fp32/model-dtype pages, no --spec-k)")
    ap.add_argument("--meshes", default="",
                    help="space-separated standby mesh names to warm "
                         "alongside --mesh (e.g. '1x2 2x2'): a mid-stream "
                         "rebind onto any of them is a hot-slot flip, "
                         "never a capture")
    ap.add_argument("--disagg", nargs="?", const=True, default=None,
                    metavar="SLICE",
                    help="disaggregated prefill/decode (DESIGN.md §17): "
                         "pin the prefill lanes to a mesh slice ('1x1@1') "
                         "while decode stays on --mesh; with no value, "
                         "the slice right after the decode mesh's "
                         "devices. The slice must be listed in --meshes; "
                         "needs --engine paged and --prefill-chunk > 0")
    ap.add_argument("--devices", default="",
                    help="the engine's logical devices, space-separated "
                         "(e.g. 'cuda:0 cuda:0': both slices of a split on "
                         "one card; 'cuda:0 cuda:0 cuda:0 cuda:0': a 2x2 "
                         "plan on one card); default each visible device "
                         "of --device's type")
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
    if args.slots < 0:
        ap.error(f"--slots must be >= 0, got {args.slots}")
    if args.async_depth < 1:
        ap.error(f"--async-depth must be >= 1, got {args.async_depth}")
    burst = args.engine in ("burst", "both", "all")
    if burst and args.prompt_len > 0:
        # the per-burst stream seeds first_token only; a side-by-side
        # report would compare different workloads
        ap.error("--prompt-len requires --engine continuous or paged (the "
                 "burst stream does not ingest prompts)")
    if burst and args.spec_k > 0:
        ap.error("--spec-k requires --engine continuous or paged (the burst "
                 "stream has no draft/verify lanes)")
    if args.kv_dtype != "fp32" and args.engine not in ("paged", "overload"):
        ap.error("--kv-dtype requires --engine paged or overload (the dense "
                 "cache has no page pool to quantise)")
    if args.engine != "overload" and (
        args.capacity or args.queue_ttl or args.deadline or args.degrade
        or args.chaos_seed is not None
    ):
        ap.error("--capacity/--queue-ttl/--deadline/--degrade/--chaos-seed "
                 "require --engine overload (the hardened serving loop)")
    if args.disagg is not None and args.engine != "paged":
        ap.error("--disagg requires --engine paged (prefill/decode "
                 "disaggregation pins the paged lanes to mesh slices)")
    if args.disagg is not None and args.prefill_chunk <= 0:
        ap.error("--disagg requires --prefill-chunk > 0 (without the "
                 "chunked prefill lane there is nothing to pin to a "
                 "prefill slice)")
    if args.engine in ("paged", "overload", "all"):
        try:
            models.check_paged(_config(args))
        except ValueError as e:
            ap.error(f"--engine {args.engine}: {e}")
    return args


def _config(args: argparse.Namespace):
    cfg = get_config(args.arch)
    return cfg.smoke() if args.smoke else cfg


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    cfg = _config(args)
    if cfg.input_kind != "tokens":
        raise SystemExit(
            f"{cfg.name} has a stub modality frontend; the serving loop "
            f"feeds sampled ids back and needs a token-input arch "
            f"(e.g. olmo-1b)."
        )
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
        mesh=args.mesh,
        meshes=tuple(args.meshes.split()),
        devices=tuple(args.devices.split()),
    )
    slots = args.slots or None
    engines = {"both": ("continuous", "burst"),
               "all": ("continuous", "burst", "paged")}.get(
                   args.engine, (args.engine,))
    # One Telemetry for every engine of the run (DESIGN.md §14); the
    # flight recorder records only when a trace is asked for, the capture
    # analysis only when the compile report is.
    telemetry = Telemetry(enabled=args.trace_out is not None,
                          compile_analysis=args.compile_report is not None)
    reports = {}
    pipeline = dict(async_steps=args.async_steps, async_depth=args.async_depth)
    for name in engines:
        reqs = make_requests(args, cfg.vocab_size, name)
        eng_cfg = ecfg
        if name == "overload" and args.degrade and "int8" not in (
            ecfg.kv_dtype, *ecfg.kv_dtypes
        ):
            # warm the int8 standby pool so the ladder's bottom rung (an
            # admission-routed pool flip) is expressible
            eng_cfg = dataclasses.replace(
                ecfg, kv_dtypes=(*ecfg.kv_dtypes, "int8"))
        with Engine(cfg, params, eng_cfg, telemetry=telemetry,
                    device=device) as eng:
            if name == "burst":
                reports[name] = run_burst_stream(eng, reqs, seed=args.seed)
            elif name == "continuous":
                reports[name] = run_continuous_stream(
                    eng, reqs, slots=slots, seed=args.seed, **pipeline)
            elif name == "overload":
                reports[name] = run_overload_stream(
                    eng, reqs, slots=slots, seed=args.seed,
                    async_steps=args.async_steps, kv_dtype=args.kv_dtype,
                    capacity=args.capacity or None,
                    shed_policy=args.shed_policy,
                    queue_ttl_s=args.queue_ttl or None,
                    degrade=args.degrade,
                    faults=(FaultPlan.random(args.chaos_seed)
                            if args.chaos_seed is not None else None),
                )
            else:
                reports[name] = run_paged_stream(
                    eng, reqs, slots=slots, seed=args.seed,
                    disagg=args.disagg, **pipeline)
    for path in (args.trace_out, args.metrics_out, args.compile_report):
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
    if args.trace_out:
        trace = write_trace(args.trace_out, telemetry.recorder)
        print(f"[serve] trace: {args.trace_out} "
              f"({len(trace['traceEvents'])} events, "
              f"{telemetry.recorder.dropped} dropped) — open in "
              f"ui.perfetto.dev", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(telemetry.registry.to_prometheus()
                     if args.metrics_out.endswith(".prom")
                     else telemetry.metrics_json())
        print(f"[serve] metrics: {args.metrics_out}", flush=True)
    if args.compile_report:
        with open(args.compile_report, "w") as fh:
            json.dump(telemetry.compile_reports, fh, indent=2)
        print(f"[serve] compile report: {args.compile_report} "
              f"({len(telemetry.compile_reports)} keys)", flush=True)
    rep = reports if len(engines) > 1 else reports[args.engine]
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        for r in reports.values():
            _print_report(r)
    return rep


if __name__ == "__main__":
    main()
