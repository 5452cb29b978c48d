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
   softcap mode (B7 from flags), on the same head layouts, fed the model's
   ``[B, S, H, dh]`` layout as strided views; in bf16 at dh 64 and 128 (the
   tensor-core body) also at lengths 1, 64, 65, 129 and a ragged 1056, and
   64 queries over 200 keys; B2/B4's tensor-core body (bf16, dh 64 and 128)
   also at chunks 1, 5, 63, 64, 65 and 130, groups 1, 5 and 16, pages of 8
   and 16, a window of 40 crossing page boundaries and starts off page
   boundaries; B1/B3's cluster-split body (dh 128 fp32 and bf16, dh 64
   bf16) at every split count 1-8, groups 1, 5 and 16, pages of 8 and 16,
   every mode, positions 0 and on page boundaries, short rows beside a
   64-page row; B5 on the same body over a dense cache at every split count
   1-8, groups 1, 5 and 16, dh 16 and 128 (fp32, bf16) and 64 (bf16), every
   mode, positions 0, 15, 16, the last row and one whose window crosses a
   16-row block; B1-B7 at head_dim 64 in fp32 (hft-demo's 4/4 heads) and
   in bf16 (granite-moe's 16/8 heads, a group of 2, and the 4/4 layout, a
   group of 1), every mode; bf16 head_dim-64 views TMA cannot load refused
   by B2/B4/B6/B7 and bf16 at head_dim 32 (no instantiation) by every
   wrapper, without a launch; B1-B4 on 512-page tables (gemma2-27b's
   max_len 8192 at page 16) at positions past a 4096 window. Phase 1 also
   checks the head_dim-64 instantiations' ptxas report: 65 in fp32 and 65
   in bf16, no spills.
2b. The sampling kernel (``sample_rows``: the steps' threefry categorical
   draw, greedy argmax and key split) against its plain version
   (``repro_torch.prng``) on the card, at 8 rows of 50304, 151936, 256000
   and 49155 and one row of 50304, float32 and bfloat16, mixed temperatures
   and greedy flags: new keys and every element's score bit for bit (so
   the random bits, the uniform and the gumbel), tokens equal or a near-tie
   within one ulp of the score dtype (counted); the burst's
   ``categorical_rows`` equal; the plain threefry's bits on the card equal
   the CPU's.
3. The serving paths: olmo-1b at full width (bf16, seeded random weights)
   serving a shared-prefix stream through ``run_paged_stream`` with chunked
   prefill — first on bf16 pages (B1/B2), then on int8 pages with
   speculative decoding (k up to 4, a 2-layer int8 draft; B3/B4) — and a
   Poisson stream through the per-burst engine (``run_burst_stream``:
   ``set_mode`` + ``decode_loop``, B5), each with the kernels' launch counts
   set to 0 just before it and every other kernel held at 0 launches (the
   spec cell's draft lanes run B3/B4 over the int8 draft cache's page
   view); ``sample_rows`` launches once per sampling step (k times per
   draft call), its count held to the graph targets' replays. Every branch target of these paths is a CUDA graph
   (``EngineConfig.cuda_graphs``' default on the card), captured once over
   the engine's pools and caches; a replay counts the kernel launches it
   holds.
3b. Graph targets against the eager steps (``cuda_graphs=False``): the
   bf16, int8+spec and burst cells' traffic on the first 4 of olmo-1b's
   16 layers (and mamba2's burst traffic in phase 6, on 12 of its 48)
   each run both ways under one step clock on the same weights and
   requests; greedy tokens equal, or a request's first divergence is a
   near-tie on the card, sampled tokens equal (the same keys through the
   same kernel); captures after warmup 0 on the paged streams, the
   distinct keys met on the burst streams; peak memory with every target
   captured. Then one step of ``cbp``, ``pf``, ``vf``+``dr`` and
   ``burst`` (and mamba2's ``burst``), graph and eager in the same call,
   as the serving loop takes it, at full depth: host wall, the host's
   launch calls per step (the CUDA runtime calls ``torch.profiler``
   records: ``cudaGraphLaunch``, ``cudaLaunchKernel``/``Ex``, copies),
   device busy, idle share and the B1-B5 kernels seen inside the replay.
3c. The dense continuous engine (``run_continuous_stream``: 8 slots of one
   dense cache, ``max_len`` 1024, olmo-1b bf16) on 16 requests at 20 req/s,
   a quarter sampled: (a) distinct 128-token prompts with ``prefill_chunk``
   64 (lanes ``cb``/``pfd``: B1/B2 over the cache's identity page view),
   (b) the same with ``spec_k`` 4 and a 2-layer int8 draft (``vfd``,
   ``dr``, ``drp``: B2, B3, B4), (c) phase 3's prompt-less burst stream
   through the continuous engine, set beside the burst engine's report.
   Each on the wall clock with its counts set to 0 just before and every
   kernel's count held to one launch per layer per lane call (k per draft
   layer per ``dr`` call), counted from the graph targets' replays; zero
   captures after warmup; then graphs against the eager steps under one
   step clock; one replayed ``cb`` step profiled graph vs eager.
3d. The async step pipeline (``async_steps``) against the synchronous loop
   on the paged bf16 cell's and dense cell (a)'s streams, each run sync
   then async on one engine (graph targets) under a clock that moves with
   the batcher's step count (so both admit each request at the same step):
   every token equal, sampled ones too, the same steps and lane calls, 0
   captures after warmup, in-flight depth >= 2; tok/s over the wall time
   of the steps, ``host_plan_ms``, ``device_wait_ms`` for both, and 20
   steady decode steps of each engine profiled sync and async (host wall
   against device busy: the idle share).
4. One paged prefill step and one paged decode step at full width with the
   kernels and with the plain attention, on identical inputs, for bf16 and
   int8 pages; the prompt-then-burst path (``prefill`` of 8 prompts of 256
   with B6, ``pad_cache`` to 1024, ``decode_loop`` of 32 greedy tokens with
   B5) held against ``forward`` (B6) over prompt + tokens, and ``forward``
   with B6 against the naive attention; then profiled windows of full-width
   decode steps (bf16 and int8 pages: B1's and B3's share), speculative
   steps (int8 pages), `pf` steps
   (8 rows x chunk 64 on bf16 and on int8 pages: B2's and B4's share) and
   burst steps: device busy vs host wall.
5. The smoke config's stream, a third of its requests sampled, on the card
   (graph targets) and on the CPU under one step clock, sampled tokens
   included: plain, and with speculation on model-dtype pages (B2 through
   the verify lane) and on int8 pages; the spec streams' greedy requests
   equal the plain ones; a stream with half its requests sampled through
   graph targets equals the eager targets'. The same for the dense
   continuous engine: olmo-1b with chunked prefill, with speculation and an
   int8 draft, and mamba2-370m through ``cb``, card = CPU; and mamba2's
   burst stream. (granite-moe's smoke streams card = CPU run in phase 9.)
6. mamba2 (B8): the SSD chunked scan against its plain version on the
   smoke config's heads (chunks 4, 8, 16; S 16, 32 and a ragged 20) and on
   mamba2-370m's (chunk 256; S 1, 255, 256, 257, 1024, 1056 and 2048; bf16
   there runs the tensor-core body), fp32 and bf16, with B and C as
   stride-0 views of one group; then mamba2-370m at full width
   (48 layers, bf16, seeded weights): ``prefill`` of 8 prompts of 1024
   (B8), ``pad_cache`` (SSM slots untouched), 32 greedy burst tokens on the
   recurrent state, ``forward`` over the 1056 tokens (B8; exactly 2 x 48
   launches) against the burst's tokens and against ``ssd_scan``, profiled
   prefill (which must show the tensor-core B8 kernel) and burst steps, and the olmo burst cell's traffic through the
   per-burst engine; the smoke config's greedy burst stream card = CPU.
7. The paper's kernel pair through ``KernelBranch`` (B6 specialised against
   B7 from flags, in the causal, causal + window 256 and causal + softcap 50
   modes, at 8 x 1024 tokens); then kernel timing at the main paths' shapes
   (B4 also at the verify window's, B8 at the mamba2 prefill's): kernel
   (per call, and B1-B5 and B8 also device-only), plain version,
   one PyTorch library call where one exists (a yardstick the port never
   calls) and the bound, and the B7 / B6 time ratio per mode; and
   ``sample_rows`` at phase 2b's shapes beside its plain version, the old
   noise tail and its bound (bytes or int32 operations at the card's SM
   clock).

8. The rest of the dense model path at full width, one model at a time,
   weights seeded on the card (init peak: the weights and one f32 slab;
   qwen3-14b on 2 of its 40 layers, gemma2-27b on 2 of its 46 and
   hft-demo on 2 of its 4, so that the script keeps its length with
   phases 9-16 added):
   qwen3-14b (bf16, 40 heads over 8: a GQA group of 5) on phase 3's
   paged bf16 cell, dense cell (a) and burst cell; gemma2-27b (bf16, local
   layers of window 4096 and global ones, softcaps 50 and 30) on 2 slots of
   8192 with two 5000-token prompts through the paged and dense engines
   and on the burst cell; hft-demo (fp32, head_dim 64, window 128) on
   prompts of 200 and bursts of ~200 tokens. Each engine's stream runs
   through graph targets (counts set to 0 just before, read after, each
   held to one launch per attention layer per lane call from the targets'
   replays) and again eager under one step clock (captures after warmup 0,
   or the burst keys; greedy tokens equal or a near-tie); peak memory
   against the reckoned weight and KV bytes. gemma2-27b and hft-demo then
   ``prefill`` (B6) past their windows and take one paged decode step
   (B1) with the kernels and with the plain attention (within
   ``STEP_LOGIT_ATOL`` / ``FP32_LOGIT_ATOL``), and with the window off
   (farther apart: the window masks); hft-demo's paged stream card = CPU.
   Then B1, B2, B5 and B6 timed at the new shapes (group 5, window 4096
   past it, fp32 head_dim 64, and phase 9's bf16 head_dim 64 with B4 as
   well) beside their plain versions, SDPA and bounds, in each kernel's
   ``new_shapes``.

9. granite-moe-1b-a400m at full width (24 layers, bf16, 32 experts top-8,
   16 heads over 8 of 64: B1-B7 on the bf16 head_dim-64 instantiations),
   weights seeded on the card (the routers float32): phase 3's paged bf16
   cell, dense cell (a), the burst cell and phase 3's int8+spec paged cell
   under ``moe_policy="drop"`` on the first 3 layers (a depth cut with
   weights of its own), each through graph targets (counts set to
   0 just before, held to one launch per attention layer per lane call)
   and again eager under one step clock (captures after warmup 0, or the
   burst keys; greedy tokens equal or a near-tie, sampled ones equal),
   peak memory against the reckoned weights plus KV (+1.5 GB).
   Under "drop" capacity follows each call's length, so a chunk or a
   verify window may drop what token-by-token decode keeps: the streams
   are held graph to eager, never speculative to plain. Then the
   prompt-then-burst path (``prefill`` 8 x 256 on B6, 32 burst tokens on
   B5, ``forward`` over 288 on B6; prefill and forward under "dense",
   which drops nothing, as the one-token burst steps never do); one
   full-width decode step under "drop", "dense" and "gather" (agreeing
   within ``STEP_LOGIT_ATOL``: nothing drops at S = 1); a replayed ``cbp``
   step profiled graph vs eager (wall, busy, idle share) and again with
   every MoE tail replaced by zeros, the busy difference being the MoE's
   share; and the smoke config's paged, dense continuous and burst streams
   card (graphs) = CPU, a third sampled.

10. The last five configs, weights seeded on the card, every stream through
   graph targets (counts set to 0 just before, held to one launch per
   attention layer per lane call) and again eager under one step clock,
   peak memory within the card and logged against the reckoned weight and
   KV bytes: deepseek-67b (bf16, 64 heads over 8: a GQA group of 8; 2 of
   its 95 layers) on phase 3's paged bf16 cell, dense cell
   (a) and the burst cell and the prompt-then-burst path; grok-1-314b
   (bf16, 48 over 8: a group of 6, softcaps 30/30, 8 experts top-2 of d_ff
   32768; 2 of its 64 layers) under "drop" on the paged bf16
   cell, phase 3's int8+spec paged cell (its draft 1 layer) and the burst
   cell, the
   prompt-then-burst path at 2 x 512 and one decode step per policy at 2
   rows, logged in bf16 and held on fp32 weights of its first layer;
   jamba-1.5-large-398b's smoke config card (graphs) = CPU through the
   dense continuous engine (prompts token by token) and the burst engine,
   then its two-layer full-width cut (one mamba2 layer of 256 SSD heads
   with a 16-expert MoE, one attention layer of 64 over 8 heads with a
   dense MLP; 11.9 B) through ``prefill`` over 2 x 1024 (B8 at 256 heads,
   B6 at group 8), 32 burst tokens and ``forward``, a dense continuous
   stream and the burst cell, kernels vs the plain path held on fp32
   weights; internvl2-1b (14 heads over 2 of 64) and musicgen-medium (24
   MHA heads of 64) at full width and depth: seeded ``[8, 256, D]``
   embeddings through ``prefill`` (B6), ``pad_cache``, ``set_mode`` and a
   one-step ``decode_loop`` through the graph target's ``[8, 1, D]`` bf16
   input (B5), ``forward`` over the 257 positions (B6), graph = eager,
   and the smoke configs' one-step tokens card = CPU. Then the new-shape
   timing (phase 8's, with B3 at granite's shape, groups 6 (softcap 30)
   and 8, group 7 and MHA 24 at head_dim 64, olmo-1b's shard at model
   size 2 (8 of 128: phase 14's B1 and B2, phase 15's B3 and B4, B4 also
   over a verify window of 8 x 5) and B8 at 256 heads).
11. The overload-hardened paged stream (run after phase 3d, on olmo-1b's
   weights): one engine (8 slots, ``max_len`` 1024, page 16, chunked
   prefill 64, the int8 pool warmed beside the bf16 one, ``spec_k`` 4
   with a 2-layer int8 draft, graph targets) runs the bf16 cell's traffic
   through ``run_paged_stream`` and through ``run_overload_stream`` with
   every knob at its default, sync and async, under a clock that moves
   with the batcher's steps: every token equal, nothing shed, cancelled,
   failed or unserved, no ladder move, 0 captures after warmup, B1-B4 and
   ``sample_rows`` launches equal between the two loops. Then a flood on
   a fresh engine, under the same step clock (both batchers' steps; the
   pull stall and the watchdog act on the wall clock): 96 shared-prefix requests at 2000
   req/s (a quarter sampled, every fourth with a 0.5 s deadline), a
   drop-oldest queue of 16 with a 50 ms TTL, the degradation ladder, the
   watchdog, and a fault plan armed before the engine warms (a capture at
   build, two poisoned emissions, a 50 ms pull stall, two dry page
   allocations, a heartbeat outage): every request finished, shed,
   cancelled or failed exactly once, every fault detected and contained
   (or its request failed), no negative token, a downward ladder move, the
   int8 standby admitting requests and replaying its B3/B4 targets, 0
   captures after warmup, each kernel's launches = the targets' replays;
   tok/s, latency, TTFT, shed by reason, rung dwell, stragglers, peak
   memory against the reckoned bytes logged. The flood again with the
   flight recorder on: the Chrome trace validates with a track per lane
   that ran plus the dispatcher, scheduler and page-pool; the Prometheus
   text parses; the registry's shed, cancel and fault counters are the
   report's robustness block. The two flood arms, seeing the same
   stragglers, give every request the same fate, the same shed counts by
   reason and the same ladder transitions (the watchdog acts on the wall
   clock and a straggler moves the ladder: where the arms' stragglers
   differ, the transitions made before the controller's call at the first
   difference agree). Last the
   launcher's ``--engine overload
   --degrade --chaos-seed 7 --trace-out --metrics-out`` as a subprocess on
   the card (smoke config).

12. Training, after phase 11 and again at the end. First C13 on the
   card: phase 3's bf16 cell (olmo-1b, graph targets) run once, then again
   on the same engine with a second paged batcher of the same key built at
   the first batcher's third step, which then serves the same stream:
   both streams' tokens equal the first run's, 0 captures in the second
   run. Then olmo-1b at full width (bf16, remat "block" as its config
   says): ``make_train_fn`` for 12 steps at 8 x 512 on one repeated
   synthetic batch (the naive attention; B1-B8 and ``sample_rows`` launch
   0 times): losses and grad norms finite, step 12's loss below step 1's;
   the median step by CUDA events past 2 warm steps, tokens/s, peak memory
   against the reckoned bytes (params, grads, f32 moments, activations).
   A two-layer cut at olmo-1b's widths (bf16): 6 steps, save, restore
   (``checkpoint.CheckpointManager``), 6 more against 12 uninterrupted
   (bytes and seconds written logged). The smoke configs of olmo-1b and
   mamba2-370m: 3 fp32 steps card = CPU. The launcher ``python -m
   repro_torch.launch.train --smoke`` for 10 steps, then ``--resume`` to
   20, as subprocesses on the card.
13. The mesh coordinate and disaggregated prefill/decode (after phase 12's
   C13 check): olmo-1b at full width (bf16), 8 slots, page 16, chunk 64,
   max_len 1024, the decode mesh "1x1" and the prefill slice "1x1@1" both
   on this card (``devices=("cuda:0", "cuda:0")``: two pools, the page
   handoff a device-local copy). First B4's tensor-core body where a
   never-written row (scale 0) leads a tile: finite, = plain (the body
   took 1 / 0 there before PR 27). The reference's ``mixed()`` stream at full
   width (one request of prompt 64 and 256 new tokens beside 12 prompts of
   512 with 4 each, all at 0) shared, then disaggregated, sync and async, on
   bf16 pages and on int8 pages: tokens equal, every prompt migrates its
   pages (388 of them), 0 captures after warmup, each kernel's launches =
   the replays' reckoning per slice (the arm's own path); a split ->
   collapse -> split run (2 rebinds), a prompt repeated after its
   migration (a trie hit, the same tail), the slices' pools distinct, the
   peak against weights + two pools. The bf16 engine is warmed with the
   capture report on: no key's report an error; the ``cbp``, ``pf`` and
   ``mg`` keys' flops, bytes, kernel share, capture ms and roofline floor,
   and the replayed ``cbp`` / ``pf`` steps against that floor; the smoke
   config's report on the card = a CPU engine's; and the launcher with
   ``--meshes 1x1@1 --disagg --devices "cuda:0 cuda:0" --compile-report``
   as a subprocess.
14. Meshes of more than one logical device (after phase 13): olmo-1b at
   full width (bf16) on 4 of its 16 layers, 8 slots, page 16, chunk 64,
   max_len 1024, ``devices=("cuda:0",) * 4`` and the ladder 1x1 / 1x2 /
   2x1 / 2x2, every target a CUDA graph (the tensor-parallel weights
   split over "model", each mesh's pool over its data rows). The bf16
   cell's stream under a step clock at 1x1, 1x2 and 2x2, then 1x2 -> 2x2
   -> 1x1 mid-stream: 0 captures after warmup, 2 rebinds, pool_shards 2,
   each kernel's launches = the replays' reckoning (layers x dp x mp per
   step for B1 and B2, one ``sample_rows`` a step), tokens = 1x1's but
   where 1x1's decision was a near-tie (greedy: the two tokens' logits,
   sampled: the sampler's scores under the row's key, within
   ``STEP_LOGIT_ATOL``); one decode step's and one prefill chunk's
   logits at 1x2 and 2x2 within ``STEP_LOGIT_ATOL`` of 1x1's on one pool
   content; a replayed ``cbp`` step's wall and busy ms at each mesh; the
   peak against the reckoned bytes; the fp32 smoke config at 1x2 and 2x2
   card = CPU (sampled too); ``pipeline_forward`` over 4 logical stages
   = ``reference_forward`` within 1e-5 (fp32); ``compressed_psum`` card
   = CPU; the launcher's ``--mesh 1x2 --meshes "1x1 2x2" --devices
   "cuda:0 cuda:0 cuda:0 cuda:0"`` as a subprocess.
15. Every lane of both continuous engines on those meshes (after phase
   14): olmo-1b at full width (bf16) on 4 of its 16 layers, 8 slots,
   page 16, chunk 64, max_len 1024, ``devices=("cuda:0",) * 4`` and the
   ladder 1x1 / 1x2 / 2x2, every target a CUDA graph. Phase 3's
   int8+spec cell (an int8 pool, ``spec_k`` 4, a 2-layer int8 draft) on
   a paged engine, then phase 3c's dense cells (a) ``cb`` + ``pfd`` and
   (b) with speculation on one dense engine: each cell's stream under a
   step clock at 1x1, 1x2 and 2x2, then 1x2 -> 2x2 -> 1x1 mid-stream (at
   a quarter and a half of 1x1's steps): 0 captures after warmup, 2
   rebinds, each kernel's launches = the replays' reckoning (layers x dp
   x mp per ``cbp``, ``pf``, ``vf``, ``cb``, ``pfd``, ``vfd`` and
   ``drp`` call, k x 2 x dp x mp per ``dr`` call; B3/B4 on the int8 pool
   and draft), the speculative lanes stepped where the cell speculates,
   tokens = 1x1's but where 1x1's decision was a near-tie (over int8
   pages for the int8 cell); a replayed ``cbp`` step over int8 pages,
   ``vf`` step at k 4 and dense ``cb`` step at each mesh (wall, busy);
   each engine's peak between its reckoned bytes (weights, the split
   pieces, every mesh's pools, dense and draft caches) and the card's
   memory; the fp32 smoke config card = CPU at 1x2, 2x2 and 1x4 (its 2
   kv heads whole: the pool replicated, the dense caches' sequence
   split) on both engines (an int8 pool with speculation; the dense
   engine with speculation).
16. Disaggregation over multi-device slices and the overload stream on a
   plan (after phase 15; it reads phase 13's one-device streams): olmo-1b
   at full width (bf16), 8 slots, ``devices=("cuda:0",) * 4``.
   ``DisaggPlan.split("2x2")`` (decode 1x2, prefill 1x2@2) on bf16 and
   int8 pools, sync and async, and ``split("3x1")`` (decode 2x1, prefill
   1x1@2; bf16, sync), phase 13's ``mixed()`` stream, each arm its own
   path (counts set to 0 just before, held to the replays per slice): 0
   captures after warmup, tokens = phase 13's one-device shared stream
   but where its decision was a near-tie, migrations and migrated pages =
   phase 13's split; at 1x2 split -> collapse -> split (2 rebinds), one
   migration of 30 pages by CUDA events, every warmed key's capture
   report without an error (the decode slice's ``cbp`` key: one device's
   flops, bytes and collective bytes), a replayed ``cbp`` step on the
   decode slice, the slices' pools distinct, each engine's peak against
   its reckoned bytes; then phase 11's inert arm (sync) and its flood in
   two arms (``_flood_arms_equal``) on ``mesh="1x2"``.

17. Training on a mesh of logical devices (after phase 12): olmo-1b at
   full width and depth (bf16, remat "block"), phase 12's batch of 8 x
   512, the sharded train step (``steps.lower_for`` of a train shape:
   FSDP over "data", TP over "model", the batch over the data rows) at
   1x1, 1x2 and 2x2 on logical devices of this card
   (``make_debug_mesh``: ``cuda:0`` at every coordinate, no CPU
   fallback), 3 steps each with phase 12's optimizer (peak_lr 1e-3, so
   the first step moves bf16 weights): the first loss and grad_norm = the
   one-device ``make_train_fn``'s within 1e-2 relative; after one step
   each leaf's unsharded mu within 1e-1 (relative L2) of 1x1's and its
   params differing from 1x1's in at most 12% of its elements; every
   replica of a piece and every step counter equal bit for bit; losses
   and grad norms finite; the step ms by CUDA events, the peak against
   the reckoned bytes, and one more step counted
   (``capture_analysis.analyze_step``: a device's flops and collective
   bytes by op type). B1-B8 and ``sample_rows`` launch 0 times (training
   runs cuBLAS and the plain attention). The fp32 smoke config's step at
   2x2 on the card = the CPU's at 1x1 within 2e-4 relative (loss, params,
   moments); the elastic re-mesh on a 2-layer fp32 cut: a step at 2x2,
   save, restore (= the saved state bit for bit), place onto 1x2, a step
   = two uninterrupted steps at 1x1 within 2e-4 (loss, params, moments).
18. The MoE family on meshes of logical devices (after phase 17):
   granite-moe-1b-a400m at full width (bf16, 32 experts top-8, float32
   routers) on 4 of its 24 layers, phase 14's engine shape, the ladder
   1x1 / 1x2 / 2x2 over ``devices=("cuda:0",) * 4``, every target a CUDA
   graph, the MoE tail's experts split over "model" (EP). The bf16 cell's
   stream under ``moe_policy="drop"`` at 1x1, 1x2 and 2x2: 0 captures
   after warmup, B1/B2 launches = layers x dp x mp per replay and one
   ``sample_rows`` a step, the requests whose tokens leave 1x1's counted
   (a bf16 rounding of a TP sum moves one of granite's random routing
   choices, as in phase 9); the same on the weights in fp32, tokens =
   1x1's but near-ties (phase 14's rule, held);
   one decode step's and one prefill chunk's logits at 1x2 and 2x2 under
   each of "drop", "dense" and "gather" against 1x1's (bf16 logged; the
   same weights in fp32 held to ``STEP_LOGIT_ATOL``, as phase 9 holds
   granite's); a replayed ``cbp`` step's wall and busy ms at each mesh;
   the 1x2 ``cbp`` key's capture report (GFLOP, its all-reduce bytes = the
   reckoning: the head's partial logits, per layer ``wo``'s and the MoE
   tail's float32 sum); the peak against the reckoned bytes; phase 3's
   int8+spec cell at 1x2 (B3/B4, launches = the replays); the mesh train
   step at 1x2 and 2x2, 3 steps with phase 12's optimizer: the first
   loss, ``moe_aux`` and ``grad_norm`` within 1e-2 of one device's, no
   kernel launched; granite's fp32 smoke config card = CPU at 2x2.
19. Context-parallel attention (``perf.seq_shard_fallback``) and the
   embeddings-input family on logical devices of this card (after phase
   18), bf16, seeded numpy embeddings and tokens: internvl2-1b at full
   width and depth at 1x4 (14 heads, 2 kv heads: neither divides 4) and
   1x2 (both divide): ``lower_for`` prefill of 8 x 512 with the fallback
   off and on, last-token logits within ``STEP_LOGIT_ATOL`` of one
   device's naive ``prefill`` and of each other, 2 decode steps on the
   emitted cache against one device's, the 1x4 prefill's capture report
   (a device's flops and all-gather bytes, off against on), one train
   step at 1x4 off and on (phase 12's optimizer: the first loss and
   ``grad_norm`` within 1e-2 of one device's ``make_train_fn``);
   musicgen-medium on 4 of its 48 layers at 2x2 (the vocab split):
   prefill and train the same; qwen3-14b on 2 of its 40 layers at 1x16
   (40 heads): prefill off and on; each arm ms by CUDA events, no kernel
   launched on the mesh steps. gemma2-27b on 2 of its 46 layers through
   the paged engine (bf16 pages) at 1x1 and 1x2: 0 captures after warmup,
   B1/B2 launches = the replays' reckoning, per shard and per mode
   (window + softcap, softcap), 1x2's tokens = 1x1's but near-ties.

It prints the card line, a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
from collections import Counter
import subprocess
import sys
import time
from functools import cache, partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# The H100 peaks and each kernel's work reckoning (the bound column) live
# in ``repro_torch.roofline``, imported where a bound is computed.
# Kernel vs plain, same inputs. fp32: both sum in fp32, in another order ->
# 1e-4. bf16: the plain version runs in fp32 on the same bf16 values; the
# kernels compute scores and the softmax in fp32 and round the output to
# bf16 (relative 2^-9, outputs here are |o| < 4), and the tensor-core bodies
# of B6/B7 and B2/B4 (bf16, head_dim 128) also round the probabilities P to
# bf16 before P V (relative 2^-9 on each weight of a convex sum, as SDPA's
# flash kernels do; B4 folds the V scale into P first) -> 2e-2.
KERNEL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Full-width logits, kernel vs plain attention: the plain tail rounds scores
# and probabilities to bf16 (as the JAX package does), the kernels keep them
# in fp32; 16 bf16 layers amplify that into differences of order 0.1 on
# logits of order 1. (On int8 pages both compute in fp32 and round the
# attention output to bf16, so they agree more closely.)
STEP_LOGIT_ATOL = 0.25
# The same for fp32 models (hft-demo: 4 layers): the kernels and the plain
# attention sum in other orders, 10x the fp32 kernel tolerance on logits.
FP32_LOGIT_ATOL = 1e-3
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
    tc = _ptxas_by_kernel(info["log"], "flash_tc")
    check(len(tc) == 18, f"expected 18 tensor-core flash instantiations (B6 x "
          f"8 modes, B7; head_dim 64 and 128), the build log has {len(tc)}")
    log(f"[setup] tensor-core flash body (B6 x 8 modes, B7; dh 64/128): "
        f"registers {min(r for r, _ in tc.values())}.."
        f"{max(r for r, _ in tc.values())}, spill stores max "
        f"{max(sp for _, sp in tc.values())} B")
    pf = _ptxas_by_kernel(info["log"], "paged_prefill_tc")
    check(len(pf) == 32, f"expected 32 tensor-core paged prefill "
          f"instantiations (B2, B4 x head_dim 64/128 x 2 page sizes x 4 "
          f"modes), the build log has {len(pf)}")
    spill = max(sp for _, sp in pf.values())
    log(f"[setup] tensor-core paged prefill body (B2, B4 x dh 64/128 x "
        f"pages 8/16 x 4 modes): registers {min(r for r, _ in pf.values())}.."
        f"{max(r for r, _ in pf.values())}, spill stores max {spill} B")
    check(spill == 0, f"the tensor-core paged prefill body spills {spill} B")
    sp = _ptxas_by_kernel(info["log"], "paged_decode_split")
    check(len(sp) == 192, f"expected 192 cluster-split paged decode "
          f"instantiations (B1, B3 x 2 query types x head_dim 16/64/128 x "
          f"pages 8/16 x 4 modes x R 1/4), the build log has {len(sp)}")
    spill = max(s_ for _, s_ in sp.values())
    log(f"[setup] cluster-split paged decode body (B1, B3): registers "
        f"{min(r for r, _ in sp.values())}..{max(r for r, _ in sp.values())}"
        f", spill stores max {spill} B")
    check(spill == 0, f"the cluster-split paged decode body spills {spill} B")
    dn = _ptxas_by_kernel(info["log"], "dense_decode_split")
    check(len(dn) == 48, f"expected 48 cluster-split dense decode "
          f"instantiations (B5 x 2 types x head_dim 16/64/128 x 4 modes x R "
          f"1/4), the build log has {len(dn)}")
    spill = max(s_ for _, s_ in dn.values())
    log(f"[setup] cluster-split dense decode body (B5): registers "
        f"{min(r for r, _ in dn.values())}..{max(r for r, _ in dn.values())}"
        f", spill stores max {spill} B")
    check(spill == 0, f"the cluster-split dense decode body spills {spill} B")
    # head_dim 64 (a template argument "Li64E" in the mangled names; B8's
    # P 64 excluded): fp32 on the CUDA-core bodies and the split body, bf16
    # (a "13__nv_bfloat16" query type) on the split body and the
    # tensor-core bodies
    dh64 = {k: v for body in ("paged_decode_split", "dense_decode_split",
                              "paged_prefill_kernel", "flash_simt",
                              "paged_prefill_tc", "flash_tc")
            for k, v in _ptxas_by_kernel(info["log"], body).items()
            if "Li64E" in k}
    bf64 = {k: v for k, v in dh64.items()
            if "_tc" in k or "13__nv_bfloat16" in k}
    check(len(dh64) - len(bf64) == 32 + 8 + 16 + 9,
          f"expected 65 fp32 head_dim-64 instantiations (B1/B3 32, B5 8, "
          f"B2/B4 16, B6 8 + B7 1), the build log has {len(dh64) - len(bf64)}")
    check(len(bf64) == 32 + 8 + 16 + 9,
          f"expected 65 bf16 head_dim-64 instantiations (B1/B3 32 and B5 8 "
          f"on the split body, B2/B4 16 and B6 8 + B7 1 on the tensor-core "
          f"bodies), the build log has {len(bf64)}")
    fp64 = {k: v for k, v in dh64.items() if k not in bf64}
    for label, group in (("fp32 (CUDA-core and split bodies)", fp64),
                         ("bf16 (split and tensor-core bodies)", bf64)):
        spill = max(s_ for _, s_ in group.values())
        log(f"[setup] head_dim 64, {label}: {len(group)} instantiations, "
            f"registers "
            f"{min(r for r, _ in group.values())}.."
            f"{max(r for r, _ in group.values())}, spill stores max {spill} B")
        check(spill == 0, f"a {label} head_dim-64 instantiation spills "
              f"{spill} B")
    ssd = _ptxas_by_kernel(info["log"], "ssd_chunk_tc")
    check(len(ssd) == 1, f"expected one tensor-core SSD instantiation (B8, "
          f"bf16 at 256/64/128), the build log has {len(ssd)}")
    (regs, spill), = ssd.values()
    log(f"[setup] tensor-core SSD body (B8): {regs} registers, spill stores "
        f"{spill} B")


def _ptxas_by_kernel(text: str, name: str) -> dict:
    """{mangled kernel: (registers, spill store bytes)} of the kernels whose
    name holds ``name``, from nvcc's ``-Xptxas -v`` log."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1) if name in m.group(1) else None
            spill = 0
        elif current and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[current], current = (regs, spill), None
    return out


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

    # group 16 splits a decode block's query heads over two row tiles;
    # heads of 64 in fp32 (hft-demo's 4/4, a group of 1) and bf16
    # (granite-moe's 16/8, a group of 2, and the 4/4 layout)
    shapes = {"olmo-1b": (16, 16, 128, 16), "gqa-40/8": (40, 8, 128, 16),
              "gqa-32/2": (32, 2, 128, 16), "smoke": (4, 2, 16, 8),
              "hft-demo": (4, 4, 64, 16), "granite": (16, 8, 64, 16)}
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
            for dtype in _dtypes(dh):
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
        for dtype in _dtypes(dh):
            worst.update(_dense_cases(f"{sname}/{str(dtype)[6:]}", h, kh, dh,
                                      dtype, seed=len(worst)))
        if dh in (64, 128):  # the tensor-core body's edges: tails, Sq != Sk
            for sq, sk in TC_EDGE_LENGTHS:
                worst.update(_flash_cases(
                    f"{sname}/bfloat16/sq={sq}/sk={sk}", h, kh, dh,
                    torch.bfloat16, seed=len(worst), sq=sq, sk=sk))
    worst.update(_prefill_tc_cases())
    worst.update(_decode_split_cases())
    worst.update(_dense_split_cases())
    worst.update(_long_table_cases())
    _bf16_dh64_checks()
    _tc_routes_profiled()
    for dtype in ("float32", "bfloat16"):
        errs = {k: v for k, v in worst.items() if f"/{dtype}" in k}
        log(f"[kernels] {len(errs)} {dtype} cases pass, max abs err "
            f"{max(errs.values()):.3g} (tolerance "
            f"{KERNEL_ATOL[getattr(torch, dtype)]})")
    for dh in (64, 128):
        names = [n for n, shape in shapes.items() if shape[2] == dh]
        tc = {k: v for k, v in worst.items() if "/sq=" in k
              and any(f"/{n}/bfloat16/" in k for n in names)}
        log(f"[kernels] tensor-core B6/B7 edges at dh {dh} (lengths "
            f"{[sq for sq, sk in TC_EDGE_LENGTHS if sq == sk]}, Sq 64 over "
            f"Sk 200; {len(tc) // (16 * len(TC_EDGE_LENGTHS))} layouts x 8 "
            f"modes): {len(tc)} cases, max abs err {max(tc.values()):.3g}")
    for kname in ("decode", "decode_int8"):
        sp = {k: v for k, v in worst.items() if k.startswith(f"split_{kname}/")}
        bf64 = {k: v for k, v in sp.items() if "/dh=64/" in k}
        log(f"[kernels] cluster-split {kname} edges (S 1-{SPLIT_MAX}, groups "
            f"{SPLIT_GROUPS}, pages 8/16, 4 modes, window {TC_WINDOW}, "
            f"positions 0 and on page boundaries, short rows beside a "
            f"{SPLIT_LONG_PAGES}-page row; dh 128 fp32 and bf16, dh 64 "
            f"bf16): {len(sp)} cases, max abs err fp32 "
            f"{max(v for k, v in sp.items() if k.endswith('float32')):.3g}, "
            f"bf16 {max(v for k, v in sp.items() if k.endswith('bfloat16')):.3g}"
            f" (dh 64: {max(bf64.values()):.3g})")
    sp = {k: v for k, v in worst.items() if k.startswith("split_dense/")}
    log(f"[kernels] cluster-split dense decode (B5) edges (S 1-{SPLIT_MAX}, "
        f"groups {SPLIT_GROUPS}, head_dim 16/128 fp32 and bf16, 64 bf16, 4 "
        f"modes, window {TC_WINDOW}, positions {DENSE_POSITIONS} of "
        f"{DENSE_SEQ}): {len(sp)} cases, max abs err fp32 "
        f"{max(v for k, v in sp.items() if k.endswith('float32')):.3g}, "
        f"bf16 {max(v for k, v in sp.items() if k.endswith('bfloat16')):.3g}")
    for dtype, what in (
        (torch.float32, "hft-demo's 4/4 heads, page 16: B1-B7 every mode"),
        (torch.bfloat16, "granite-moe's 16/8 heads and the 4/4 layout, page "
         "16: B1-B7 every mode, the B6/B7 edges; the B2/B4 and split-body "
         "edges at pages 8/16"),
    ):
        name = str(dtype)[6:]
        dh64 = {k: v for k, v in worst.items() if k.endswith(name) or
                f"/{name}/" in k}
        dh64 = {k: v for k, v in dh64.items()
                if "/hft-demo/" in k or "/granite/" in k or "/dh=64/" in k}
        log(f"[kernels] {name} head_dim 64 ({what}): {len(dh64)} cases, max "
            f"abs err {max(dh64.values()):.3g} (tolerance "
            f"{KERNEL_ATOL[dtype]})")
    long = {k: v for k, v in worst.items() if k.startswith("long/")}
    log(f"[kernels] {LONG_PAGES}-page tables (gemma2-27b's 32/16 heads of "
        f"128, bf16, page 16, window 4096 and softcap 50 on and off, "
        f"positions past 4096): B1-B4, {len(long)} cases, max abs err "
        f"{max(long.values()):.3g}")
    for kname in ("prefill", "prefill_int8"):
        tc = {k: v for k, v in worst.items() if k.startswith(f"tc_{kname}/")}
        log(f"[kernels] tensor-core {kname} edges (chunks {TC_CHUNKS}, groups "
            f"{TC_GROUPS}, pages 8/16, dh 64/128, 4 modes, window "
            f"{TC_WINDOW}, starts off page boundaries): {len(tc)} cases, max "
            f"abs err {max(tc.values()):.3g} (dh 64: "
            f"{max(v for k, v in tc.items() if '/dh=64/' in k):.3g})")


def _dtypes(dh: int) -> tuple:
    """The query types B1-B7 are instantiated for at ``dh``."""
    from repro_torch.kernels import build

    return tuple(dt for dt in (torch.float32, torch.bfloat16)
                 if dh in build.HEAD_DIMS[dt])


def _misaligned(t: torch.Tensor, view: bool = False) -> torch.Tensor:
    """``t``'s values at a base one element past 16-byte alignment: a
    contiguous copy, or (``view``) a view whose every stride but the last
    is odd as well."""
    if view:
        wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype,
                           device=t.device)
        out = wide[..., 1:]
    else:
        flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
        out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    check(out.data_ptr() % 16 != 0, "the misaligned copy is aligned")
    return out


def _bf16_dh64_checks() -> None:
    """No fallback around the bf16 head_dim-64 instantiations: a bf16 view
    at head_dim 64 that TMA cannot load raises in the tensor-core
    wrappers (B2/B4 a misaligned q, B6/B7 a misaligned strided k), and bf16
    at head_dim 32, which no body instantiates, raises in every wrapper of
    B1-B7; none counts a launch."""
    from repro_torch import kernels

    q, kp, vp, bt, pos = _kernel_inputs(16, 8, 64, 16, torch.bfloat16,
                                        chunk=0, seed=0)
    qc = _kernel_inputs(16, 8, 64, 16, torch.bfloat16, chunk=8, seed=0)[0]
    (kq, ks), (vq, vs) = _quantised(kp.float()), _quantised(vp.float())
    full = qc.transpose(1, 2)
    kv = full[:, ::2]
    flags = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda")
    misaligned = {
        "B2": lambda: kernels.paged_prefill_attention(
            _misaligned(qc), kp, vp, bt, pos),
        "B4": lambda: kernels.paged_prefill_attention_int8(
            _misaligned(qc), kq, vq, ks, vs, bt, pos),
        "B6": lambda: kernels.flash_attention(
            full, _misaligned(kv, view=True), kv),
        "B7": lambda: kernels.flash_attention_branchy(
            full, _misaligned(kv, view=True), kv, flags),
    }
    q32, k32, v32 = (t[..., :32].contiguous() for t in (q, kp, vp))
    qc32, f32 = qc[..., :32].contiguous(), full[..., :32]
    d32 = k32.view(4, -1, 8, 32).transpose(1, 2)
    p0 = torch.tensor(5, dtype=torch.int32, device="cuda")
    (kq32, ks32), (vq32, vs32) = _quantised(k32.float()), _quantised(
        v32.float())
    uninstantiated = {
        "B1": lambda: kernels.paged_decode_attention(q32, k32, v32, bt, pos),
        "B2": lambda: kernels.paged_prefill_attention(qc32, k32, v32, bt, pos),
        "B3": lambda: kernels.paged_decode_attention_int8(
            q32, kq32, vq32, ks32, vs32, bt, pos),
        "B4": lambda: kernels.paged_prefill_attention_int8(
            qc32, kq32, vq32, ks32, vs32, bt, pos),
        "B5": lambda: kernels.decode_attention(q32, d32, d32, p0),
        "B6": lambda: kernels.flash_attention(f32, f32[:, ::2], f32[:, ::2]),
        "B7": lambda: kernels.flash_attention_branchy(
            f32, f32[:, ::2], f32[:, ::2], flags),
    }
    before = {k.__name__: k.launches for k in kernels.KERNELS}
    for what, calls, match in (
        ("bf16 head_dim 64, misaligned", misaligned,
         "cannot be loaded by TMA"),
        ("bf16 head_dim 32", uninstantiated, "no kernel instantiated"),
    ):
        for name, call in calls.items():
            try:
                call()
            except ValueError as e:
                check(match in str(e), f"{name} {what}: {e}")
            else:
                raise AssertionError(f"{name} ran {what}")
    check(before == {k.__name__: k.launches for k in kernels.KERNELS},
          "a refused call counted a launch")
    log(f"[kernels] refused without a launch: bf16 head_dim 64 views TMA "
        f"cannot load ({', '.join(misaligned)}), bf16 at head_dim 32 "
        f"({', '.join(uninstantiated)})")


def _tc_routes_profiled() -> None:
    """B2, B4, B6 and B7 in bf16 at head_dim 64 (granite-moe's 16/8 heads),
    one call each under ``torch.profiler``: every attention kernel the
    profile records is the tensor-core body's, instantiated at 64
    (``paged_prefill_tc_kernel<..., 64, ...>``, ``flash_tc_kernel<64,
    ...>``, ``flash_tc_branchy_kernel<64>``), never a CUDA-core body's. Up
    to three tries each, as a profile has recorded no kernels on some runs;
    these launches are not a path's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    qc, kp, vp, bt, st = _kernel_inputs(16, 8, 64, 16, torch.bfloat16,
                                        chunk=64, seed=3)
    (kq, ks), (vq, vs) = _quantised(kp.float()), _quantised(vp.float())
    full = qc.transpose(1, 2)
    kv = full[:, ::2]
    flags = torch.tensor([1, 0, 0], dtype=torch.int32, device="cuda")
    calls = {
        "B2": (kernels.paged_prefill_attention, "paged_prefill_tc_kernel",
               lambda: kernels.paged_prefill_attention(qc, kp, vp, bt, st)),
        "B4": (kernels.paged_prefill_attention_int8, "paged_prefill_tc_kernel",
               lambda: kernels.paged_prefill_attention_int8(
                   qc, kq, vq, ks, vs, bt, st)),
        "B6": (kernels.flash_attention, "flash_tc_kernel",
               lambda: kernels.flash_attention(full, kv, kv)),
        "B7": (kernels.flash_attention_branchy, "flash_tc_branchy_kernel",
               lambda: kernels.flash_attention_branchy(full, kv, kv, flags)),
    }
    seen_by = {}
    for name, (fn, want, call) in calls.items():
        saved = fn.launches
        call()
        seen = set()
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            seen = {e.key for e in prof.key_averages()
                    if "paged_prefill" in e.key or "flash_" in e.key}
            if seen:
                break
        fn.launches = saved
        check(bool(seen), f"{name} bf16 head_dim 64: three profiles recorded "
              f"no attention kernel")
        check(all(want in k and "64" in k for k in seen),
              f"{name} bf16 head_dim 64 ran {sorted(seen)}, not {want} at 64")
        seen_by[name] = sorted(k[:90] for k in seen)
    log(f"[kernels] bf16 head_dim 64 on the tensor-core bodies, by the "
        f"profiler's kernel names: {seen_by}")


# B1-B4 over block tables of gemma2-27b's max_len 8192 at page 16: rows of
# 512 pages, positions past its 4096 window.
LONG_PAGES = 512


def _long_table_cases() -> dict:
    """B1-B4 (bf16, 32/16 heads of 128, page 16) against their plain
    versions on 512-page tables: 2 rows whose pages are scattered over a
    pool of 1025, decode at positions 5000 and 8191, chunks of 64 from 5000
    and 8128; window 4096 and softcap 50 on and off."""
    from repro_torch import kernels

    errs, h, kh, dh, ps = {}, 32, 16, 128, 16
    g = torch.Generator().manual_seed(512)
    n_pages = 2 * LONG_PAGES + 1
    kp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
    vp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
    (kq, ks), (vq, vs) = _quantised(kp), _quantised(vp)
    kb, vb = kp.bfloat16(), vp.bfloat16()
    bt = (torch.randperm(n_pages - 1, generator=g) + 1).view(2, LONG_PAGES)
    bt = bt.to(torch.int32).to("cuda")
    pos = torch.tensor([5000, 8191], dtype=torch.int32, device="cuda")
    start = torch.tensor([5000, 8128], dtype=torch.int32, device="cuda")
    q1 = torch.randn(2, h, dh, generator=g).to("cuda", torch.bfloat16)
    qc = torch.randn(2, 64, h, dh, generator=g).to("cuda", torch.bfloat16)
    for window, cap in ((None, None), (4096, None), (None, 50.0),
                        (4096, 50.0)):
        kw = dict(window=window, softcap=cap)
        for kname, fn, plain, q, at, pages, ref_pages in (
            ("decode", kernels.paged_decode_attention,
             kernels.paged_decode_attention_plain, q1, pos, (kb, vb),
             (kb.float(), vb.float())),
            ("prefill", kernels.paged_prefill_attention,
             kernels.paged_prefill_attention_plain, qc, start, (kb, vb),
             (kb.float(), vb.float())),
            ("decode_int8", kernels.paged_decode_attention_int8,
             kernels.paged_decode_attention_int8_plain, q1, pos,
             (kq, vq, ks, vs), (kq, vq, ks, vs)),
            ("prefill_int8", kernels.paged_prefill_attention_int8,
             kernels.paged_prefill_attention_int8_plain, qc, start,
             (kq, vq, ks, vs), (kq, vq, ks, vs)),
        ):
            _held(errs, f"long/{kname}/w={window}/cap={cap}/bfloat16",
                  fn(q, *pages, bt, at, **kw),
                  plain(q.float(), *ref_pages, bt, at, **kw), torch.bfloat16)
    return errs


# B2/B4's tensor-core body (bf16, dh 128): chunks of one token, the verify
# lane's 5, one short of / exactly / one past a 64-row tile and two tiles +
# 2; GQA groups 1, 5 (Q by 16-byte loads) and 16 (Q by TMA, four chunk
# tokens a tile); a window that crosses page boundaries.
TC_CHUNKS = (1, 5, 63, 64, 65, 130)
TC_GROUPS = (1, 5, 16)
TC_WINDOW = 40


def _prefill_tc_cases() -> dict:
    """B2 and B4 in bf16 at dh 64 and 128 against their plain versions over
    every ``TC_CHUNKS`` x ``TC_GROUPS`` x page size x mode, 2 kv heads, 3
    rows whose starts lie off page boundaries, each row's pages scattered
    over the pool and its table padded with the null page 0."""
    from repro_torch import kernels

    errs, kh = {}, 2
    modes = [(None, None), (TC_WINDOW, None), (None, 30.0), (TC_WINDOW, 30.0)]
    for dh, ps in ((dh, ps) for dh in (64, 128) for ps in (8, 16)):
        start = [5, ps + 3, 3 * ps - 1]
        pb = -(-(max(start) + max(TC_CHUNKS)) // ps) + 1
        g = torch.Generator().manual_seed(ps + dh)
        n_pages = 3 * pb + 1
        kp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
        vp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
        (kq, ks), (vq, vs) = _quantised(kp), _quantised(vp)
        kb, vb = kp.bfloat16(), vp.bfloat16()
        # (name, kernel, plain version, its pages, the plain version's)
        cases = (("prefill", kernels.paged_prefill_attention,
                  kernels.paged_prefill_attention_plain, (kb, vb),
                  (kb.float(), vb.float())),
                 ("prefill_int8", kernels.paged_prefill_attention_int8,
                  kernels.paged_prefill_attention_int8_plain,
                  (kq, vq, ks, vs), (kq, vq, ks, vs)))
        perm = torch.randperm(n_pages - 1, generator=g) + 1
        st = torch.tensor(start, dtype=torch.int32, device="cuda")
        for chunk in TC_CHUNKS:
            # each row's pages, then the null page past what it needs
            bt = perm[: 3 * pb].view(3, pb).clone()
            for r, s_ in enumerate(start):
                bt[r, -(-(s_ + chunk) // ps):] = 0
            bt = bt.to(torch.int32).to("cuda")
            for group in TC_GROUPS:
                q = torch.randn(3, chunk, kh * group, dh, generator=g).to(
                    "cuda", torch.bfloat16)
                for window, cap in modes:
                    kw = dict(window=window, softcap=cap)
                    for kname, fn, plain, pages, ref_pages in cases:
                        _held(errs, f"tc_{kname}/c={chunk}/G={group}/ps={ps}/"
                              f"dh={dh}/w={window}/cap={cap}/bfloat16",
                              fn(q, *pages, bt, st, **kw),
                              plain(q.float(), *ref_pages, bt, st, **kw),
                              torch.bfloat16)
    return errs


# B1/B3's cluster-split body: every split count, GQA groups 1 (one row a
# CTA), 5 and 16 (tiles of 4 rows), rows at key 0, on page boundaries and
# short beside one of 64 pages (the bucket of a 1024-token row at page 16).
SPLIT_MAX = 8
SPLIT_GROUPS = (1, 5, 16)
SPLIT_LONG_PAGES = 64


def _decode_split_cases() -> dict:
    """B1 and B3 against their plain versions at every S 1-``SPLIT_MAX``
    (past a short row's pages: CTAs without pages) x ``SPLIT_GROUPS`` x
    page size x mode, head_dim 128 in fp32 and bf16 and head_dim 64 in
    bf16, 2 kv heads; the window leaves lane groups and warps of its first
    page with only masked keys. Pages are scattered over the pool, tables
    padded with the null page 0."""
    from repro_torch import kernels

    errs, kh = {}, 2
    modes = [(None, None), (TC_WINDOW, None), (None, 30.0), (TC_WINDOW, 30.0)]
    for dh, ps in ((dh, ps) for dh in (64, 128) for ps in (8, 16)):
        pos = [0, ps - 1, ps, 2 * ps - 1, 3 * ps + 5,
               SPLIT_LONG_PAGES * ps - 1]
        g = torch.Generator().manual_seed(100 + ps + dh)
        n_pages = 2 * SPLIT_LONG_PAGES + 1
        kp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
        vp = torch.randn(n_pages, ps, kh, dh, generator=g).to("cuda")
        (kq, ks), (vq, vs) = _quantised(kp), _quantised(vp)
        bt = torch.zeros(len(pos), SPLIT_LONG_PAGES, dtype=torch.int32)
        for r, p in enumerate(pos):
            need = p // ps + 1
            bt[r, :need] = (torch.randperm(n_pages - 1, generator=g) + 1)[:need]
        bt = bt.to("cuda")
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for group in SPLIT_GROUPS:
            qf = torch.randn(len(pos), kh * group, dh, generator=g).to("cuda")
            for dtype in ((torch.bfloat16,) if dh == 64
                          else (torch.float32, torch.bfloat16)):
                q = qf.to(dtype)
                # (name, kernel, plain version, its pages, the plain's)
                cases = (("decode", kernels.paged_decode_attention,
                          kernels.paged_decode_attention_plain,
                          (kp.to(dtype), vp.to(dtype)),
                          (kp.to(dtype).float(), vp.to(dtype).float())),
                         ("decode_int8", kernels.paged_decode_attention_int8,
                          kernels.paged_decode_attention_int8_plain,
                          (kq, vq, ks, vs), (kq, vq, ks, vs)))
                for window, cap in modes:
                    kw = dict(window=window, softcap=cap)
                    for kname, fn, plain, pages, ref_pages in cases:
                        ref = plain(q.float(), *ref_pages, bt, pt, **kw)
                        for splits in range(1, SPLIT_MAX + 1):
                            _held(errs, f"split_{kname}/S={splits}/G={group}/"
                                  f"ps={ps}/dh={dh}/w={window}/cap={cap}/"
                                  f"{str(dtype)[6:]}",
                                  fn(q, *pages, bt, pt, splits=splits, **kw),
                                  ref, dtype)
    return errs


# B5 on the cluster-split body: a ragged dense cache of 70 rows (blocks of
# 16), positions at 0, at the first block's last row, at the second's first,
# one whose window of TC_WINDOW crosses a block edge, and the last row.
DENSE_SEQ = 70
DENSE_POSITIONS = (0, 15, 16, 41, DENSE_SEQ - 1)


def _dense_split_cases() -> dict:
    """B5 against its plain version at every S 1-``SPLIT_MAX`` x
    ``SPLIT_GROUPS`` x head_dim 16/128 in fp32 and bf16 and 64 in bf16 x
    mode x ``DENSE_POSITIONS``, 2 kv heads, on the model's ``[B, S, KH,
    dh]`` cache passed as a transposed view."""
    from repro_torch import kernels

    errs, kh = {}, 2
    modes = [(None, None), (TC_WINDOW, None), (None, 30.0), (TC_WINDOW, 30.0)]
    g = torch.Generator().manual_seed(200)
    for dh in (16, 64, 128):
        kf, vf = (torch.randn(2, DENSE_SEQ, kh, dh, generator=g).to("cuda")
                  for _ in range(2))
        for group in SPLIT_GROUPS:
            qf = torch.randn(2, kh * group, dh, generator=g).to("cuda")
            for dtype in ((torch.bfloat16,) if dh == 64
                          else (torch.float32, torch.bfloat16)):
                q, k, v = (t.to(dtype) for t in (qf, kf, vf))
                k, v = k.transpose(1, 2), v.transpose(1, 2)
                for pos in DENSE_POSITIONS:
                    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    for window, cap in modes:
                        kw = dict(window=window, softcap=cap)
                        ref = kernels.decode_attention_plain(
                            q.float(), k.float(), v.float(), p, **kw)
                        for splits in range(1, SPLIT_MAX + 1):
                            _held(errs, f"split_dense/S={splits}/G={group}/"
                                  f"dh={dh}/pos={pos}/w={window}/cap={cap}/"
                                  f"{str(dtype)[6:]}",
                                  kernels.decode_attention(
                                      q, k, v, p, splits=splits, **kw),
                                  ref, dtype)
    return errs


# (Sq, Sk) of B6/B7 in bf16 at dh 128 beside the 200-token case: one row,
# one and a bit of a 64-row warpgroup, one and a bit of a 128-key tile, a
# ragged 1056 (8 tiles + 32), and fewer queries than keys.
TC_EDGE_LENGTHS = ((1, 1), (64, 64), (65, 65), (129, 129), (1056, 1056),
                   (64, 200))


def _held(errs: dict, name: str, out, ref, dtype) -> None:
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    errs[name] = err
    check(err <= KERNEL_ATOL[dtype],
          f"{name}: max abs err {err:.3g} > {KERNEL_ATOL[dtype]}")


def _flash_cases(tag: str, h: int, kh: int, dh: int, dtype, *, seed: int,
                 sq: int, sk: int) -> dict:
    """B6 and B7 (flags) in every causal x window x softcap mode on the
    model's [B, S, H, dh] layout passed as transposed views."""
    from repro_torch import kernels

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, s, n, dh, generator=g).to("cuda", dtype)
               .transpose(1, 2) for s, n in ((sq, h), (sk, kh), (sk, kh)))
    ref_in = [t.float() for t in (q, k, v)]
    errs = {}
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
                _held(errs, f"flash/{mode}/{tag}", out, ref, dtype)
                flags = torch.tensor([int(causal), window or 0, int(cap or 0)],
                                     dtype=torch.int32, device="cuda")
                _held(errs, f"branchy/{mode}/{tag}",
                      kernels.flash_attention_branchy(q, k, v, flags), ref,
                      dtype)
    return errs


def _dense_cases(tag: str, h: int, kh: int, dh: int, dtype, *, seed: int,
                 seq: int = 200) -> dict:
    """B6 and B7 in every mode and B5 at pos 0, mid and last, on the model's
    [B, S, H, dh] layout passed as transposed views; the sequence is ragged
    against the kernels' tiles."""
    from repro_torch import kernels

    errs = _flash_cases(tag, h, kh, dh, dtype, seed=seed, sq=seq, sk=seq)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, seq, n, dh, generator=g).to("cuda", dtype)
               .transpose(1, 2) for n in (h, kh, kh))
    ref_in = [t.float() for t in (q, k, v)]
    for pos in (0, seq // 2, seq - 1):
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for window, cap in ((None, None), (48, None), (None, 30.0), (48, 30.0)):
            kw = dict(window=window, softcap=cap)
            _held(errs, f"dense_decode/pos={pos}/w={window}/cap={cap}/{tag}",
                  kernels.decode_attention(q[:, :, 0], k, v, p, **kw),
                  kernels.decode_attention_plain(
                      ref_in[0][:, :, 0], *ref_in[1:], p, **kw), dtype)
    return errs


# ----------------------------------------------------------------- phase 2b
# The sampling kernel's cases: every served vocabulary (olmo-1b, qwen3-14b,
# gemma2-27b, granite-moe's odd 49155) at 8 rows, and one row; float32 (the
# serving steps' logits) and bfloat16.
SAMPLE_SHAPES = ((8, 50304), (8, 151936), (8, 256000), (8, 49155),
                 (1, 50304))


def _sampling_inputs(rows: int, vocab: int, dtype, seed: int):
    """Logits of a trained model's spread, temperatures 0-2 (0 clamps to
    1e-4), every third row greedy, keys as a batcher draws them."""
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(rows, vocab, generator=g) * 4).to("cuda", dtype)
    temps = (torch.rand(rows, generator=g) * 2).to("cuda")
    temps[0] = 0.0
    greedy = (torch.arange(rows) % 3 == 1).to("cuda")
    return logits, temps, greedy, _row_keys(rows, seed=seed)


def sampling_vs_plain() -> None:
    """``sample_rows`` against its plain version on the card: the new keys
    and every element's score (so the random bits, the uniform and the
    gumbel) bit for bit, then the tokens; where a token differs, both
    candidates' scores must lie within one ulp of the score dtype (a
    near-tie), counted. ``categorical_rows`` (the sampled burst) the same
    way on its tokens. The plain threefry's bits on the card equal the
    CPU's."""
    from repro_torch import kernels, prng
    from repro_torch.kernels import sampling

    keys = _row_keys(8, seed=1)
    for width in (32, 8):
        card = prng.random_bits(keys, width, (50304,))
        check(torch.equal(card.cpu(), prng.random_bits(keys.cpu(), width,
                                                        (50304,))),
              f"prng.random_bits({width}): card != CPU")
    saved = kernels.sample_rows.launches  # checks are not main-path launches
    for rows, vocab in SAMPLE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            logits, temps, greedy, keys = _sampling_inputs(rows, vocab, dtype,
                                                           seed=vocab + rows)
            scores = torch.empty(rows, vocab, device="cuda")
            tok, new_keys = kernels.sample_rows(logits, temps, greedy, keys,
                                                scores=scores)
            ptok, pkeys = sampling.sample_rows_plain(logits, temps, greedy,
                                                     keys)
            want = sampling.sample_scores_plain(logits, temps, greedy, keys)
            torch.cuda.synchronize()
            tag = f"sample_rows {rows}x{vocab} {str(dtype)[6:]}"
            check(torch.equal(new_keys, pkeys), f"{tag}: new keys differ")
            off = int((scores != want).sum())
            ulp = torch.finfo(dtype).eps * want.abs().clamp_min(1.0)
            check(bool(((scores - want).abs() <= ulp).all()),
                  f"{tag}: scores beyond one ulp of the plain version's")
            ties = 0
            for r in torch.nonzero(tok != ptok).flatten().tolist():
                a, b = want[r, tok[r]], want[r, ptok[r]]
                check(bool((a - b).abs() <= ulp[r, ptok[r]]),
                      f"{tag}: row {r} token {int(tok[r])} vs plain "
                      f"{int(ptok[r])}, scores {float(a)} / {float(b)}")
                ties += 1
            flat = kernels.categorical_rows(keys[0], logits, 0.8)
            pflat = sampling.categorical_rows_plain(keys[0], logits, 0.8)
            flips = int((flat != pflat).sum())
            check(flips == 0, f"{tag}: categorical_rows differs on {flips} rows")
            log(f"[sampling] {tag}: new keys equal, scores (bits, uniform, "
                f"gumbel, logits / t) bit-equal on all but {off} of "
                f"{rows * vocab} elements, {ties} near-tie token flips; "
                f"categorical_rows equal on every row")
    kernels.sample_rows.launches = saved


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


def _release_engines() -> None:
    """Free the memory of engines no longer used (an engine sits in a
    reference cycle until the collector runs), so a peak reads one path."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _warm_runs_per_key() -> int:
    """Step runs of one warmed graph target: the eager runs before its
    capture, then the warm replay."""
    from repro_torch.core.graph_target import WARMUP_RUNS

    return WARMUP_RUNS + 1


def _check_stream(label: str, cfg, reqs, rep: dict) -> None:
    check(rep["finished"] == len(reqs),
          f"{label}: finished {rep['finished']}/{len(reqs)}")
    for r in reqs:
        check(len(r.tokens) == r.new_tokens, f"{label} rid {r.rid}: short stream")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{label} rid {r.rid}: token outside the vocabulary")


def _shared_prefix_traffic(cfg) -> list:
    """The bf16 and int8+spec cells' stream: 16 Poisson requests at 20
    req/s over 4 shared 128-token prefixes, tokens mean 16, a quarter
    sampled."""
    from repro_torch.runtime.scheduler import shared_prefix_arrivals

    return shared_prefix_arrivals(
        16, 20.0, seed=0, num_prefixes=4, prefix_len=128, tokens_mean=16,
        total_max=1024, sample_frac=0.25, vocab=cfg.vocab_size)


def _burst_traffic(cfg, tokens_mean: int = 16) -> list:
    """The burst cell's stream: 16 prompt-less Poisson requests at 20 req/s,
    a quarter sampled."""
    from repro_torch.runtime.scheduler import poisson_arrivals

    return poisson_arrivals(16, 20.0, seed=0, tokens_mean=tokens_mean,
                            tokens_max=1024, sample_frac=0.25,
                            vocab=cfg.vocab_size)


def _continuous_traffic(cfg, prompt_len: int = 128) -> list:
    """16 requests, Poisson 20 req/s, tokens mean 16, a quarter sampled,
    with distinct prompts of ``prompt_len`` tokens (none for 0), drawn as
    the launcher's ``make_requests`` draws them for ``--max-len 1024``."""
    from repro_torch.runtime.scheduler import (
        attach_distinct_prompts,
        poisson_arrivals,
    )

    reqs = poisson_arrivals(
        16, 20.0, seed=0, tokens_mean=16,
        tokens_max=max(1, 1024 - max(prompt_len, 1) + 1), sample_frac=0.25,
        vocab=cfg.vocab_size,
    )
    if prompt_len:
        attach_distinct_prompts(reqs, prompt_len, vocab=cfg.vocab_size, seed=1)
    return reqs


def burst_stream(cfg, params, label: str = "burst",
                 expect: tuple = ("decode_attention", "sample_rows"),
                 ) -> tuple[dict, dict]:
    """The per-burst engine at full width: Poisson traffic (the paged
    streams' rate), a quarter sampled; every burst pays set_mode, so its
    builds after the stream starts are the distinct (bucket, mode) keys it
    meets. ``expect``: the kernels of the model's decode step (for mamba2,
    whose recurrent step is plain tensor code, the sampled bursts'
    ``sample_rows`` alone)."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import Engine, EngineConfig, run_burst_stream

    ecfg = EngineConfig(max_len=1024, max_batch=8, batch_quantum=4)
    reqs = _burst_traffic(cfg)
    _release_engines()
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
    return launches, rep


def _serve(label: str, cfg, params, ecfg, reqs, expect: tuple) -> tuple:
    """One main path: the kernels' counts set to 0 just before the stream,
    read just after; every kernel in ``expect`` must have launched and no
    other kernel may have."""
    from repro_torch import kernels
    from repro_torch.runtime.kvcache import page_bytes
    from repro_torch.runtime.serve import Engine, run_paged_stream

    _release_engines()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, ecfg) as eng:
        check(eng.graphs, f"{label}: the engine's targets are not CUDA graphs")
        rep = run_paged_stream(eng, reqs, slots=8, seed=0)
        pool_gb = (eng.pool_physical_pages * cfg.num_layers * page_bytes(
            ecfg.page_size, cfg.num_kv_heads, cfg.head_dim, ecfg.kv_dtype,
            cfg.dtype) / 1e9)
        chunk_buckets = eng._chunk_buckets()
        warm = len(chunk_buckets) + len(eng._k_buckets())
        draft_layers = eng.draft_cfg.num_layers if ecfg.spec_k else 0
        targets = len(eng._decode)
        torch.cuda.synchronize()
        draws = _lane_launches(eng)[0]["sample_rows"]
    wall = time.perf_counter() - t0
    launches = _launches(label, expect + ("sample_rows",))
    check(launches["sample_rows"] == draws,
          f"{label}: sample_rows launched {launches['sample_rows']} times, "
          f"expected {draws} (one per sampling step, k per dr call)")
    # the chunk kernel serves the pf and vf lanes, one launch per layer per
    # call, warmup's included: each warmed key runs its step once before
    # its capture and replays once to warm; a capture launches nothing.
    # With speculation the draft's prompt mirror (drp) runs it too, over
    # the draft cache's page view, one launch per draft layer per call. The
    # steps themselves follow wall-clock admission, so the count differs
    # from run to run
    steps = rep["lane_steps"]
    pf_kernel = next(k for k in expect if "prefill" in k)
    runs = _warm_runs_per_key()
    want = cfg.num_layers * (steps["prefill"] + steps["verify"] + runs * warm)
    drp = ""
    if ecfg.spec_k:
        drp_calls = rep["lane_calls"].get("drp", 0)
        want += draft_layers * (drp_calls + runs * len(chunk_buckets))
        drp = (f" + {draft_layers} draft layers x ({drp_calls} drp replays + "
               f"{runs} x {len(chunk_buckets)} warmup runs)")
    check(launches[pf_kernel] == want,
          f"{label}: {pf_kernel} launched {launches[pf_kernel]} times, "
          f"expected {want} (one per layer per pf/vf/drp call)")
    log(f"[stream:{label}] {pf_kernel} {want} launches = {cfg.num_layers} "
        f"layers x ({steps['prefill']} pf + {steps['verify']} vf replays + "
        f"{runs} x {warm} warmup runs){drp} | sample_rows {draws} launches "
        f"(one per sampling step, k per dr call, warmup runs included) | "
        f"{targets} graph targets captured")
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
        f"{rep['compiles_after_warmup']} (captures), rebinds "
        f"{rep['rebinds']} | peak memory {peak_gb:.2f} GB with every target "
        f"captured, KV pool {pool_gb:.3f} GB "
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
    from repro_torch.runtime.serve import EngineConfig

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"[stream] olmo-1b {n_params / 1e9:.3f}B params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    base = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64)
    _, launches = _serve(
        "bf16", cfg, params, EngineConfig(**base), _shared_prefix_traffic(cfg),
        ("paged_decode_attention", "paged_prefill_attention"),
    )
    by_path = {"paged bf16": dict(launches)}
    rep8, launches8 = _serve(
        "int8+spec", cfg, params,
        EngineConfig(**base, kv_dtype="int8", spec_k=4, draft_layers=2,
                     draft_kv_dtype="int8"),
        _shared_prefix_traffic(cfg),
        ("paged_decode_attention_int8", "paged_prefill_attention_int8"),
    )
    check(rep8["lane_steps"]["draft"] > 0 and rep8["lane_steps"]["verify"] > 0,
          f"int8+spec: draft/verify lane steps {rep8['lane_steps']}")
    spec = rep8["spec"]
    log(f"[stream:int8+spec] acceptance rate {spec['acceptance_rate']} "
        f"({spec['accepted_tokens']}/{spec['drafted_tokens']} drafted tokens; "
        f"a 2-layer draft of random weights), k_bucket_crossings "
        f"{spec['k_bucket_crossings']}, lane calls {rep8['lane_calls']}")
    by_path["paged int8+spec"] = dict(launches8)
    launches.update({k: v for k, v in launches8.items() if "int8" in k})
    burst_launches, burst_rep = burst_stream(cfg, params)
    launches["decode_attention"] = burst_launches["decode_attention"]
    return {"launches": launches, "params": params, "cfg": cfg,
            "burst_report": burst_rep, "by_path": by_path}


# ------------------------------------------------ phase 3b (graphs vs eager)
class _StepClock:
    """Virtual time that advances a fixed step per read: a stream forms the
    same batches whichever targets run it (graphs or eager) and on
    whichever device, so their tokens compare one for one."""

    def __init__(self, dt: float = 0.004) -> None:
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        self.t += self.dt
        return self.t

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, t)


def _tie_policy(cfg) -> str:
    """The MoE policy of a near-tie's reference pass over a whole sequence:
    "dense", which drops nothing, as a decode step (S = 1) never does;
    under "drop" one pass over the sequence would drop by its own
    capacity, which no step of the stream had."""
    moe = any(cfg.mlp_at(s) == "moe" for s in range(cfg.period))
    return "dense" if moe else "drop"


def _card_near_tie(cfg, params, seq, a: int, b: int,
                   kv_dtype: str) -> tuple[bool, float]:
    """Whether tokens ``a`` and ``b`` are a near-tie after ``seq`` at full
    width: their logits from one eager pass over ``seq`` on the card (a
    chunked prefill with the plain attention over pages of ``kv_dtype``;
    ``forward`` through B8 for an SSM stack) lie within
    ``BF16_TIE_MARGIN``."""
    row = _card_logits(cfg, params, seq, kv_dtype)
    gap = abs(float(row[a] - row[b]))
    return gap < BF16_TIE_MARGIN, gap


def _card_logits(cfg, params, seq, kv_dtype: str) -> torch.Tensor:
    """The float32 logits after ``seq`` from one eager pass on the card."""
    from repro_torch import models

    dev = "cuda"
    tok = torch.tensor([seq], dtype=torch.int32, device=dev)
    if any(cfg.mixer_at(s) == "mamba" for s in range(cfg.period)):
        logits, _ = models.forward(cfg, params, tok,
                                   moe_policy=_tie_policy(cfg))
        row = logits[0, -1].float()
    else:
        ps = 16
        n = -(-len(seq) // ps)
        cache = models.init_paged_cache(cfg, n + 1, ps, kv_dtype, device=dev)
        logits, _ = models.paged_prefill_step(
            cfg, params, cache, tok, torch.zeros(1, dtype=torch.int32,
                                                 device=dev),
            torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None],
            torch.tensor([len(seq)], dtype=torch.int32, device=dev),
            attn_impl="plain", moe_policy=_tie_policy(cfg),
        )
        row = logits[0].float()
    return row


def _paired_streams(label: str, cfg, params, ecfg: dict, traffic,
                    engine: str = "paged", slots: int = 8,
                    count: bool = False) -> dict:
    """One stream of ``engine`` (``"paged"``, ``"continuous"`` or
    ``"burst"``) through graph targets and again through the eager steps
    (``cuda_graphs=False``) on the same weights and requests, under one
    step clock: greedy tokens equal, or a request's first divergence is a
    near-tie; sampled tokens equal (both runs draw from the same per-slot
    keys through the same kernel, so only a logit that differs between the
    two runs could flip one, and a flip fails); builds (captures) after
    warmup 0 on a paged or continuous
    stream, the distinct keys met on a burst stream. With ``count`` the
    graph run is a main path: the kernels' counts set to 0 just before it
    and held to its targets' replays just after (``_held_launches``)."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_burst_stream,
        run_continuous_stream,
        run_paged_stream,
    )

    launches = None
    runs = {}
    for graphs in (True, False):
        reqs = traffic()
        _release_engines()
        torch.cuda.reset_peak_memory_stats()
        if count and graphs:
            kernels.reset_launch_counts()  # this path's run starts here
        t0 = time.perf_counter()
        with Engine(cfg, params, EngineConfig(**ecfg, cuda_graphs=graphs)) as eng:
            check(eng.graphs == graphs, f"{label}: cuda_graphs {eng.graphs}")
            if engine == "burst":
                rep = run_burst_stream(eng, reqs, clock=_StepClock())
            elif engine == "continuous":
                rep = run_continuous_stream(eng, reqs, slots=slots, seed=0,
                                            clock=_StepClock())
            else:
                rep = run_paged_stream(eng, reqs, slots=slots, seed=0,
                                       clock=_StepClock())
            torch.cuda.synchronize()
            keys = list(eng._decode.cache.stats.keys)
            if graphs and count:
                launches = _held_launches(label, eng, rep, engine)
        del eng  # its pool and graphs go before the next run's peak
        wall = time.perf_counter() - t0
        _check_stream(f"{label}/graphs={graphs}", cfg, reqs, rep)
        want = len(set(keys)) if engine == "burst" else 0
        check(rep["compiles_after_warmup"] == want,
              f"{label}/graphs={graphs}: compiles_after_warmup "
              f"{rep['compiles_after_warmup']}, expected {want}")
        runs[graphs] = (reqs, rep, wall, torch.cuda.max_memory_allocated(),
                        len(keys))
    (greqs, grep, gwall, gpeak, ntargets), (ereqs, erep, ewall, epeak, _) = (
        runs[True], runs[False])
    eager_by_rid = {r.rid: r for r in ereqs}
    kv_dtype = ecfg.get("kv_dtype", "fp32")
    equal = ties = sampled = sampled_equal = 0
    for r in greqs:
        e = eager_by_rid[r.rid]
        if not r.greedy:
            sampled += 1
            sampled_equal += r.tokens == e.tokens
            check(r.tokens == e.tokens, f"{label}: rid {r.rid} graph and "
                  f"eager sampled streams differ")
            continue
        if r.tokens == e.tokens:
            equal += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(r.tokens, e.tokens))
                 if x != y)
        ok, gap = _card_near_tie(cfg, params,
                                 list(r.effective_prompt) + r.tokens[:i],
                                 r.tokens[i], e.tokens[i], kv_dtype)
        check(ok, f"{label}: rid {r.rid} graph and eager greedy streams "
              f"differ at token {i}, logit gap {gap:.4f} >= "
              f"{BF16_TIE_MARGIN}")
        ties += 1
    tokens = sum(len(r.tokens) for r in greqs)
    host = "" if engine == "burst" else (
        f" | {grep['prompt_tokens']} prompt tokens ingested, lane calls "
        f"{grep['lane_calls']} | host_plan_ms "
        f"{grep['pipeline']['host_plan_ms']} graphs vs "
        f"{erep['pipeline']['host_plan_ms']} eager, device_wait_ms "
        f"{grep['pipeline']['device_wait_ms']} vs "
        f"{erep['pipeline']['device_wait_ms']}")
    held = "" if launches is None else (
        f" | launches {launches} = one per attention layer per lane call, "
        f"warmup runs included")
    log(f"[graphs:{label}] {cfg.name}: graphs = eager on {equal} greedy "
        f"requests, {ties} near-tie divergences; sampled {sampled_equal}/"
        f"{sampled} equal (threefry keys) | {tokens} tokens, wall incl. "
        f"warmup "
        f"{gwall:.2f}s graphs ({ntargets} targets captured, captures after "
        f"warmup {grep['compiles_after_warmup']}) vs {ewall:.2f}s eager{host}"
        f"{held} | peak memory {gpeak / 1e9:.2f} GB graphs, "
        f"{epeak / 1e9:.2f} GB eager | {_card()}")
    return {"graphs_s": gwall, "eager_s": ewall, "ties": ties,
            "launches": launches, "report": grep, "requests": greqs,
            "peak": max(gpeak, epeak)}


# B1-B5's kernels, as the profiler names them, and the host calls that put
# work on the card
_GRAPH_PATH_KERNELS = ("paged_decode_split_kernel", "paged_prefill_tc_kernel",
                       "paged_prefill_kernel", "dense_decode_split_kernel")
_HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel",
                      "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync")


def _wall_ms(run, steps: int = 20) -> float:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _profile_replay(label: str, runs: dict, steps: int = 5) -> dict:
    """One step of a lane, graph and eager (``runs``: {"graph": run,
    "eager": run}): host wall per step (20 steps, no profiler), the host's
    launch calls per step (the CUDA runtime calls ``torch.profiler``
    records with its CUDA activity alone: recording the CPU ops too made
    each eager session cost seconds of the profiler's own host time),
    device busy (its kernels' time; where it records none, CUDA events
    around queued steps), idle share, and the B1-B5 kernels seen."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode, run in runs.items():
        wall = _wall_ms(run)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
        by_name = _kernel_ms(prof, steps)
        calls = {e.key: e.count / steps for e in prof.key_averages()
                 if e.key in _HOST_LAUNCH_CALLS}
        busy, by = sum(by_name.values()), "profiler"
        seen = sorted({n for k in by_name for n in _GRAPH_PATH_KERNELS
                       if n in k})
        if busy == 0:
            busy = _queued_ms(run, torch.empty(1, device="cuda"), steps)
            by = ("cuda events (the profiler recorded no kernel of the "
                  "step)")
        idle = None if busy is None else max(0.0, 100 - 100 * busy / wall)
        out[mode] = {"wall_ms": wall, "busy_ms": busy, "idle_pct": idle,
                     "calls": calls, "kernels": seen}
        log(f"[graphs:profile] {label} {mode}: wall {wall:.3f} ms, device "
            f"busy {_fmt_ms(busy)} by {by}, idle "
            f"{'not measured' if idle is None else f'{idle:.1f}%'} | host "
            f"launch calls per step {calls} | B1-B5 kernels "
            f"{seen or 'none recorded'}")
    g, e = out["graph"], out["eager"]
    check(g["calls"].get("cudaGraphLaunch", 0) >= 1 or not g["calls"],
          f"{label}: no graph launch recorded in the graph step")
    log(f"[graphs:profile] {label}: wall {g['wall_ms']:.3f} ms graph vs "
        f"{e['wall_ms']:.3f} ms eager ({e['wall_ms'] / g['wall_ms']:.1f}x) | "
        f"{_card()}")
    return out


@cache
def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them (read
    once: neither changes while the script runs)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _row_keys(rows: int, dev: str = "cuda", seed: int = 0) -> torch.Tensor:
    """Per-row threefry keys (uint32 bits as int32), drawn as a batcher
    draws them."""
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, size=(rows, 2), dtype=np.uint32).view(np.int32)).to(dev)


def _steady_args(exe, args: list) -> list:
    """The serving loop's steady state: the arguments held in a graph
    target's static inputs (where the mirror's uploads land), so a call
    copies nothing in; an eager target takes them as they are."""
    ins = getattr(exe, "static_inputs", None)
    if ins is None:
        return list(args)
    for d, a in zip(ins, args, strict=True):
        d.copy_(a)
    return list(ins)


def _step_runs(eng, lane: str, slots: int, dev: str = "cuda"):
    """A run of one ``lane`` step on ``eng`` as the serving loop takes it,
    its per-step uploads and its d2h pull included: ``cbp`` (8 slots from
    position 200, 16-page tables, token and position chained), ``pf``
    (chunk 64 at starts 0-192, tables at the page cap; four uploads) or
    ``spec`` (``dr`` k 4, the drafts pulled, the window and lengths
    uploaded, then ``vf``)."""
    import numpy as np

    from repro_torch.core import lanes
    from repro_torch.runtime.scheduler import _upload

    i32 = torch.int32
    cfg, cap = eng.cfg, eng.max_pages_per_req
    keys = _row_keys(slots, dev)
    temps = torch.ones(slots, device=dev)
    greedy = torch.ones(slots, dtype=torch.bool, device=dev)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    bt_h = np.arange(1, slots * cap + 1, dtype=np.int32).reshape(slots, cap)
    btf = torch.from_numpy(bt_h).to(dev)
    kv = eng.ecfg.kv_dtype
    cache = eng.paged_cache(kv)
    if lane == "cbp":
        exe = eng._decode.build(lanes.CBP.key(slots, 16, kv, "1x1"))
        state = _steady_args(exe, [
            torch.zeros(slots, 1, dtype=i32, device=dev),
            torch.full((slots,), 200, dtype=i32, device=dev),
            btf[:, :16].contiguous(), active, temps, greedy, keys])

        def run():
            out = exe(cache, *state)
            # chained, as the mirror does: token, position, keys
            state[0], state[1], state[6] = out[4], out[2], out[3]
            return out[5].cpu()

        return run
    if lane == "pf":
        exe = eng._decode.build(lanes.PF.key(slots, 64, kv, "1x1"))
        rng = np.random.default_rng(9)
        hosts = [rng.integers(0, cfg.vocab_size, (slots, 64)).astype(np.int32),
                 np.array([0, 64, 128, 192] * (slots // 4), np.int32), bt_h,
                 np.full(slots, 64, np.int32)]
        keys_h = keys.cpu().numpy()
        hosts.append(keys_h)  # a synchronous chunk uploads its keys raw
        dst = getattr(exe, "static_inputs", None) or (None,) * 7
        dst = dst[:4] + dst[6:]
        fixed = _steady_args(exe, [torch.from_numpy(h).to(dev)
                                   for h in hosts[:4]]
                             + [temps, greedy, keys])

        def run():
            up = [_upload(h, dev, d) for h, d in zip(hosts, dst)]
            return exe(cache, *up[:4], fixed[4], fixed[5], up[4])[3].cpu()

        return run
    k = eng.ecfg.spec_k
    dr = eng._decode.build(lanes.DR.key(slots, k, eng.ecfg.draft_kv_dtype,
                                              "1x1"))
    vf = eng._decode.build(lanes.VF.key(slots, k, kv, "1x1"))
    dcache = eng.draft_cache(slots, eng.ecfg.draft_kv_dtype)
    pos = torch.full((slots,), 200, dtype=i32, device=dev)
    dstate = _steady_args(dr, [torch.zeros(slots, 1, dtype=i32, device=dev), pos,
                        active, temps, greedy, keys])
    len_h = np.full(slots, k + 1, np.int32)
    vfixed = _steady_args(vf, [torch.zeros(slots, k + 1, dtype=i32, device=dev),
                        pos, btf, torch.from_numpy(len_h).to(dev), temps,
                        greedy, keys])
    vdst = getattr(vf, "static_inputs", None) or (None,) * 4

    def run():
        drafts = dr(dcache, *dstate)[0].cpu().numpy()
        window = np.concatenate([np.zeros((slots, 1), np.int32), drafts], 1)
        out = vf(cache, _upload(window, dev, vdst[0]), vfixed[1], vfixed[2],
                 _upload(len_h, dev, vdst[3]), vfixed[4], vfixed[5],
                 vfixed[6])
        vfixed[6] = out[3]  # the verify target's keys chain
        return out[4].cpu()

    return run


def _burst_run(eng, bucket: int, pos: int):
    """A run of one burst step as ``decode_loop`` takes it (no pull: the
    loop chains token and position on the device): ``set_mode`` first, the
    bucket's cache zeroed."""
    from repro_torch.runtime.serve import GREEDY

    eng.set_mode(batch=bucket, sampling=GREEDY)
    exe, cache = eng._current, eng.zero_cache(eng.burst_cache(bucket))
    state = [torch.zeros(bucket, 1, dtype=torch.int32, device="cuda"),
             torch.tensor(pos, dtype=torch.int32, device="cuda"),
             torch.zeros(2, dtype=torch.int32, device="cuda")]

    def run():
        out = exe(cache, *state)
        state[0], state[1] = out[2], out[3]
        return out[0]

    return run


# olmo-1b's depth, at full width, where a path is held to another run of
# the same depth (graphs to eager in phase 3b, each mesh to its own 1x1 in
# phases 14 and 15): these runs are host-bound and scale with depth (phase
# 3b's eager twins were 41 s of the script at 16 layers). The counted
# streams of phases 1-3, the profiled steps and phases 11-13 and 16 keep
# all 16 layers.
OLMO_CUT_LAYERS = 4


def graph_phase(cfg, params) -> None:
    """olmo-1b at full width through graph targets against the eager
    steps: the bf16, int8+spec and burst cells' traffic, paired, on the
    first ``OLMO_CUT_LAYERS`` layers; then one replayed step of ``cbp``,
    ``pf``, ``vf``+``dr`` and ``burst`` at full depth, graph and eager,
    profiled."""
    from repro_torch.runtime.serve import Engine, EngineConfig

    base = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64)
    spec = dict(base, kv_dtype="int8", spec_k=4, draft_layers=2,
                draft_kv_dtype="int8")
    burst = dict(max_len=1024, max_batch=8, batch_quantum=4)
    tcfg, tparams = _depth_view(cfg, params, OLMO_CUT_LAYERS, "graphs")
    traffic = partial(_shared_prefix_traffic, tcfg)
    _paired_streams("bf16", tcfg, tparams, base, traffic)
    _paired_streams("int8+spec", tcfg, tparams, spec, traffic)
    _paired_streams("burst", tcfg, tparams, burst,
                    partial(_burst_traffic, tcfg), "burst")
    del tparams
    for label, ecfg, lane in (
        ("cbp (bf16 pages, 8 slots, pos 200, 16-page tables; B1)", base,
         "cbp"),
        ("pf (bf16 pages, 8 rows x chunk 64; B2)", base, "pf"),
        ("vf+dr (int8 pages, draft 2 layers x k 4 + 5-row verify; B3/B4 "
         "path)", spec, "spec"),
    ):
        runs = {}
        engines = []
        for mode in ("graph", "eager"):
            eng = Engine(cfg, params, EngineConfig(
                **ecfg, cuda_graphs=mode == "graph"))
            engines.append(eng)
            runs[mode] = _step_runs(eng, lane, 8)
        _profile_replay(label, runs)
        for eng in engines:
            eng.close()
        del engines, runs
    runs, engines = {}, []
    for mode in ("graph", "eager"):
        eng = Engine(cfg, params, EngineConfig(**burst,
                                               cuda_graphs=mode == "graph"))
        engines.append(eng)
        runs[mode] = _burst_run(eng, 8, 288)
    _profile_replay("burst (dense cache, 8 rows from pos 288; B5)", runs)
    for eng in engines:
        eng.close()
    torch.cuda.empty_cache()


# ------------------------------------ phase 3c (the dense continuous engine)
def _lane_kernel(key) -> str:
    """The kernel a lane's key launches: B1 (``cbp``, ``cb``, ``dr``) or B2
    (``pf``, ``vf``, ``pfd``, ``vfd``, ``drp``) — B3/B4 where the key's
    page or draft dtype is int8 — or B5 (``burst``)."""
    lane = key[0]
    if lane == "burst":
        return "decode_attention"
    name = ("paged_decode_attention" if lane in ("cbp", "cb", "dr")
            else "paged_prefill_attention")
    int8 = lane in ("cbp", "pf", "vf", "dr", "drp") and key[3] == "int8"
    return name + ("_int8" if int8 else "")


def _lane_launches(eng, mesh: str | None = None) -> tuple[dict, dict]:
    """From the engine's graph targets, independently of the kernels'
    counts: the launches each kernel should have made — every key's step
    runs ``WARMUP_RUNS`` times before its capture, and every replay (its
    warm run, ``cb``'s second on the zeroed cache, a burst key's warm run
    at each ``set_mode``, the batcher's calls) launches its lane's kernel
    once per attention layer (``k`` times per draft layer for ``dr``; on a
    mesh of dp x mp logical devices once per layer per shard, every lane),
    and
    ``sample_rows`` once (``k`` times for ``dr``; a greedy burst key not
    at all) — and each lane's replays less its warm ones. An engine warmed
    with the capture report runs each key's step once more, eagerly, at
    its build. ``mesh`` keeps the keys of one mesh (slice) only."""
    from repro_torch.core.graph_target import WARMUP_RUNS
    from repro_torch.distributed.sharding import parse_mesh_name

    runs0 = WARMUP_RUNS + int(eng.telemetry.compile_analysis)

    def attn_layers(cfg) -> int:
        return sum(cfg.mixer_at(i).startswith("attn")
                   for i in range(cfg.num_layers))

    want, calls = {}, {}
    for key in eng._decode.cache.keys():
        target = eng._decode.cache.get(key)
        lane = key[0]
        if lane == "mg":  # the page transport: no kernel, no sampling
            continue
        if mesh is not None and (lane == "burst" or key[-1] != mesh):
            continue
        replays = target.graph.replays
        if lane != "burst" or key[2] == 1:  # every step samples but greedy
            draws = key[2] if lane == "dr" else 1  # bursts'; dr k times
            want["sample_rows"] = (want.get("sample_rows", 0)
                                   + (replays + runs0) * draws)
        layers = attn_layers(eng.draft_cfg if lane in ("dr", "drp")
                             else eng.cfg)
        if not layers:
            continue
        per_run = layers * (key[2] if lane == "dr" else 1)
        if lane != "burst":  # a mesh's shards each launch (phases 14-15)
            dp, mp = parse_mesh_name(key[-1])
            per_run *= dp * mp
        kernel = _lane_kernel(key)
        want[kernel] = want.get(kernel, 0) + (replays + runs0) * per_run
        calls[lane] = calls.get(lane, 0) + replays - (2 if lane == "cb" else 1)
    return want, calls


def _held_launches(label: str, eng, rep: dict, engine: str) -> dict:
    """Read the kernels' counts after ``eng``'s stream (``_launches``) and
    hold each to ``_lane_launches``' reckoning from the graph targets'
    replays; on a batcher's stream (paged, continuous) hold each lane's
    replays past warmup to the batcher's calls."""
    want, calls = _lane_launches(eng)
    launches = _launches(label, tuple(want))
    for name, n in want.items():
        check(launches[name] == n,
              f"{label}: {name} launched {launches[name]} times, expected "
              f"{n} (one per layer per call, k per draft layer per dr call)")
    if engine != "burst":
        for lane, n in calls.items():
            check(n == rep["lane_calls"].get(lane, 0),
                  f"{label}: {lane} replayed {n} times past warmup, the "
                  f"batcher called it {rep['lane_calls'].get(lane, 0)} times")
    return launches


def _continuous_stream(label: str, cfg, params, ecfg: dict, reqs) -> tuple:
    """One main path: the dense continuous engine on the card (graph
    targets), wall clock; the kernels' counts set to 0 just before and read
    just after, each held against the targets' replays."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_continuous_stream,
    )

    _release_engines()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, EngineConfig(**ecfg)) as eng:
        check(eng.graphs, f"{label}: the engine's targets are not CUDA graphs")
        rep = run_continuous_stream(eng, reqs, slots=8, seed=0)
        torch.cuda.synchronize()
        launches = _held_launches(label, eng, rep, "continuous")
        targets = len(eng._decode)
    wall = time.perf_counter() - t0
    check(rep["compiles_after_warmup"] == 0,
          f"{label}: compiles_after_warmup {rep['compiles_after_warmup']}")
    _check_stream(label, cfg, reqs, rep)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttft = (f"ttft p50 {rep['ttft_p50_ms']:.1f} ms p95 "
            f"{rep['ttft_p95_ms']:.1f} ms")
    log(f"[continuous:{label}] {rep['finished']} requests, {rep['tokens']} "
        f"tokens ({rep['prompt_tokens']} prompt tokens ingested) in "
        f"{wall:.1f}s incl. warmup | {rep['tok_per_s']:.1f} tok/s, latency "
        f"p50 {rep['p50_ms']:.1f} ms p95 {rep['p95_ms']:.1f} ms, {ttft} | "
        f"steps {rep['steps']} lane calls {rep['lane_calls']}, "
        f"compiles_after_warmup {rep['compiles_after_warmup']} (captures), "
        f"{targets} graph targets | launches {launches} = one per layer per "
        f"lane call (k per draft layer per dr call), warmup runs included | "
        f"peak memory {peak_gb:.2f} GB | {_card()}")
    log(f"[continuous:{label}] host_plan_ms {rep['pipeline']['host_plan_ms']}"
        f" device_wait_ms {rep['pipeline']['device_wait_ms']} "
        f"tokens/target step {rep.get('tokens_per_target_step')} spec "
        f"{rep.get('spec')}")
    return rep, launches


def _dense_cb_run(eng, slots: int, mesh: str = "1x1"):
    """A run of one ``cb`` step as the serving loop takes it: 8 slots from
    position 200 of the engine's dense cache on ``mesh``, token and
    position chained, the packed pull."""
    from repro_torch.core import lanes

    dev, i32 = "cuda", torch.int32
    exe = eng._decode.build(lanes.CB.key(slots, mesh))
    cache = eng.dense_cache(slots, mesh)
    state = _steady_args(exe, [
        torch.zeros(slots, 1, dtype=i32, device=dev),
        torch.full((slots,), 200, dtype=i32, device=dev),
        torch.ones(slots, dtype=torch.bool, device=dev),
        torch.ones(slots, device=dev),
        torch.ones(slots, dtype=torch.bool, device=dev),
        _row_keys(slots, dev)])

    def run():
        out = exe(cache, *state)
        # chained, as the mirror does: token, position, keys
        state[0], state[1], state[5] = out[4], out[2], out[3]
        return out[5].cpu()

    return run


def dense_view_vs_plain() -> None:
    """B1-B4 over the dense cache's page view at the continuous cells'
    shapes, against their plain versions on the same inputs: one layer of
    an 8-slot, 1024-row cache (16 kv heads of 128; bf16 for the target's
    ``cb``/``pfd``/``vfd``, int8 for the draft's ``dr``/``drp``), 64 view
    pages of 16 a row; one token a row at positions 128-300 and the last
    row, chunks of 64 (``pfd``, ``drp``) and windows of 5 (``vfd``) at
    starts up to 960. These calls are not a path's launches."""
    from repro_torch import kernels
    from repro_torch.models import attention

    dev, dtype = "cuda", torch.bfloat16
    s, smax, h, kh, dh = 8, 1024, 16, 16, 128
    g = torch.Generator().manual_seed(13)
    i32 = torch.int32
    pos = torch.tensor([128, 140, 150, 160, 200, 250, 300, smax - 1],
                       dtype=i32, device=dev)
    start = torch.tensor([0, 64, 128, 192, 128, 140, 960, 5], dtype=i32,
                         device=dev)
    shape = (s, smax, kh, dh)
    errs = {}
    for int8 in (False, True):
        if int8:
            layer = {n: torch.randint(-127, 128, shape, generator=g,
                                      dtype=torch.int8).to(dev)
                     for n in ("k", "v")}
            layer.update({n: (torch.rand(shape[:2], generator=g) * 0.02)
                          .to(dev) for n in ("ks", "vs")})
        else:
            layer = {n: torch.randn(shape, generator=g).to(dev, dtype)
                     for n in ("k", "v")}
        pool, table = attention.dense_page_view(layer)
        pages = [pool["k"], pool["v"]] + (
            [pool["k_scale"], pool["v_scale"]] if int8 else [])
        plain_pages = pages if int8 else [t.float() for t in pages]
        sfx = "_int8" if int8 else ""
        for name, width, at in (("paged_decode_attention", 0, pos),
                                ("paged_prefill_attention", 64, start),
                                ("paged_prefill_attention", 5, start)):
            fn = getattr(kernels, name + sfx)
            plain = getattr(kernels, name + sfx + "_plain")
            qshape = (s, h, dh) if width == 0 else (s, width, h, dh)
            q = torch.randn(qshape, generator=g).to(dev, dtype)
            saved = fn.launches  # not a path's launch
            out = fn(q, *pages, table, at)
            fn.launches = saved
            ref = plain(q.float(), *plain_pages, table, at)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            tag = f"{name}{sfx} q{tuple(q.shape)}"
            check(bool(torch.isfinite(out).all())
                  and err <= KERNEL_ATOL[dtype],
                  f"{tag} over the dense page view: max abs err {err:.3g}")
            errs[tag] = err
    log(f"[continuous:view] B1-B4 over a [8, 1024, 16, 128] cache's page "
        f"view (64 pages of 16 a row), bf16 q, kernel vs plain max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {KERNEL_ATOL[dtype]})")


def continuous_phase(cfg, params, burst_rep: dict) -> dict:
    """olmo-1b at full width through the dense continuous engine (8 slots,
    ``max_len`` 1024, bf16): (a) distinct 128-token prompts with
    ``prefill_chunk`` 64 (``cb``, ``pfd``: B1, B2 over the page view); (b)
    the same with ``spec_k`` 4 and a 2-layer int8 draft (``vfd``, ``dr``,
    ``drp``: B2, B3, B4); (c) the prompt-less stream of phase 3's burst
    engine through the continuous engine, the reference's ``--engine
    both``. Each on the card's wall clock with its launches checked, then
    graph targets against the eager steps under one step clock; then one
    replayed ``cb`` step profiled, graph and eager."""
    from repro_torch.runtime.serve import Engine, EngineConfig

    base = dict(max_len=1024, max_batch=8, prefill_chunk=64)
    spec = dict(base, spec_k=4, draft_layers=2, draft_kv_dtype="int8")
    plain = dict(max_len=1024, max_batch=8)
    dense_view_vs_plain()
    out = {}
    for label, ecfg, prompt_len in (("a: cb+pfd", base, 128),
                                    ("b: spec int8 draft", spec, 128),
                                    ("c: prompt-less", plain, 0)):
        rep, launches = _continuous_stream(
            label, cfg, params, ecfg, _continuous_traffic(cfg, prompt_len))
        if prompt_len:
            check(rep["prefill_chunks"] > 0, f"{label}: no prefill chunks ran")
        if "spec_k" in ecfg:
            check(rep["lane_steps"]["draft"] > 0
                  and rep["lane_steps"]["verify"] > 0
                  and rep["lane_calls"].get("drp", 0) > 0,
                  f"{label}: spec lanes {rep['lane_calls']}")
        out[label] = {"report": rep, "launches": launches}
        _paired_streams(f"continuous {label}", cfg, params, ecfg,
                        partial(_continuous_traffic, cfg, prompt_len),
                        "continuous")
    c, b = out["c: prompt-less"]["report"], burst_rep
    log(f"[continuous:both] the prompt-less stream (16 requests, 20 req/s, "
        f"a quarter sampled), continuous vs burst engine: {c['tok_per_s']:.1f}"
        f" vs {b['tok_per_s']:.1f} tok/s, latency p50 {c['p50_ms']:.1f} vs "
        f"{b['p50_ms']:.1f} ms, p95 {c['p95_ms']:.1f} vs {b['p95_ms']:.1f} "
        f"ms, ttft p50 {c['ttft_p50_ms']:.1f} vs {b['ttft_p50_ms']:.1f} ms; "
        f"captures after warmup {c['compiles_after_warmup']} vs "
        f"{b['compiles_after_warmup']} | {_card()}")
    runs, engines = {}, []
    for mode in ("graph", "eager"):
        eng = Engine(cfg, params, EngineConfig(**plain,
                                               cuda_graphs=mode == "graph"))
        eng.continuous(slots=8)
        engines.append(eng)
        runs[mode] = _dense_cb_run(eng, 8)
    out["cb_profile"] = _profile_replay(
        "cb (dense cache, 8 slots, pos 200; B1 over the page view)", runs)
    for eng in engines:
        eng.close()
    del engines, runs
    torch.cuda.empty_cache()
    return out


def continuous_smoke_card_vs_cpu() -> None:
    """The smoke configs' continuous streams (fp32, TF32 off), a third of
    the requests sampled, on the card (graph targets) and on the CPU under
    one step clock: olmo-1b with chunked prefill, with speculation and an
    int8 draft, and mamba2-370m through ``cb`` (prompts forced token by
    token). Greedy requests equal or a near-tie; sampled ones equal."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import (
        attach_distinct_prompts,
        poisson_arrivals,
    )
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_continuous_stream,
    )

    for arch, label, ecfg in (
        ("olmo-1b", "chunked", dict(prefill_chunk=16)),
        ("olmo-1b", "spec int8 draft",
         dict(prefill_chunk=16, spec_k=2, draft_kv_dtype="int8")),
        ("mamba2-370m", "cb, prompts forced", dict()),
    ):
        cfg = get_config(arch).smoke()
        params = models.init_params(cfg, seed=0)
        streams = {}
        for dev in ("cuda", "cpu"):
            reqs = poisson_arrivals(12, 1000.0, seed=2, tokens_mean=8,
                                    tokens_max=40, sample_frac=1 / 3,
                                    vocab=cfg.vocab_size)
            attach_distinct_prompts(reqs, 20, vocab=cfg.vocab_size, seed=3)
            with Engine(cfg, params, EngineConfig(max_len=64, max_batch=4,
                                                  **ecfg), device=dev) as eng:
                rep = run_continuous_stream(eng, reqs, slots=4,
                                            clock=_StepClock())
                check(eng.graphs == (dev == "cuda"),
                      f"continuous smoke {dev}: cuda_graphs {eng.graphs}")
            check(rep["finished"] == len(reqs)
                  and rep["compiles_after_warmup"] == 0,
                  f"continuous smoke {arch} {label} {dev}: {rep['finished']} "
                  f"finished, {rep['compiles_after_warmup']} compiles after "
                  f"warmup")
            streams[dev] = {r.rid: (r.prompt, r.tokens, r.greedy)
                            for r in reqs}
        ties = 0
        for rid, (prompt, toks, greedy) in streams["cpu"].items():
            card = streams["cuda"][rid][1]
            if card == toks:
                continue
            i = next(i for i, (x, y) in enumerate(zip(toks, card)) if x != y)
            check(greedy and arch == "olmo-1b" and _near_tie(
                cfg, params, list(prompt) + toks[:i], "fp32"),
                f"continuous smoke {arch} {label}: card != CPU at rid {rid} "
                f"token {i}")
            ties += 1
        n = sum(len(t) for _, t, _ in streams["cpu"].values())
        sampled = sum(not g for _, _, g in streams["cpu"].values())
        log(f"[continuous:smoke] {arch} {label}: card = CPU on "
            f"{len(streams['cpu']) - ties} of {len(streams['cpu'])} requests "
            f"({sampled} sampled, {n} tokens), {ties} near-tie divergences")


# ------------------------------------------------ phase 3d (async vs sync)
class _BatcherClock:
    """Virtual time that moves with the batcher's own step count and jumps
    over idle gaps: a synchronous and an async run admit each request at
    the same step, so their schedules — lane calls, and the per-step key
    splits that decide sampled tokens — are the same, while the loop runs
    at the card's pace (no waiting), so the wall time between the first
    and the last step is the stream's processing time."""

    def __init__(self, dt: float = 0.004) -> None:
        self.dt = dt
        self.offset = 0.0
        self.batchers: list = []
        self.t_wall = None

    def bind(self, batcher):
        """Count ``batcher``'s steps too (a stream of two batchers, as the
        overload stream's int8 standby, moves the clock with both)."""
        self.batchers.append(batcher)
        self.t_wall = time.perf_counter()
        return batcher

    def now(self) -> float:
        steps = sum(b.stats.steps for b in self.batchers)
        return self.offset + steps * self.dt

    def jump_to(self, t: float) -> None:
        self.offset += max(0.0, t - self.now())

    def run(self, eng, runner, reqs, *, make: str = "paged_continuous",
            **kw) -> dict:
        """``runner(eng, reqs, clock=self, **kw)`` with this clock bound to
        the batcher the runner makes through ``eng.<make>`` (the method is
        restored after)."""
        orig = getattr(eng, make)
        setattr(eng, make, lambda **k: self.bind(orig(**k)))
        try:
            return runner(eng, reqs, clock=self, **kw)
        finally:
            delattr(eng, make)


def _async_stream(eng, engine: str, reqs, async_steps: bool) -> dict:
    """One stream on ``eng`` under a ``_BatcherClock``: its report, with
    the wall time from the batcher's creation (after warmup) to the end."""
    from repro_torch.runtime.serve import run_continuous_stream, run_paged_stream

    clock = _BatcherClock()
    run = run_paged_stream if engine == "paged" else run_continuous_stream
    rep = clock.run(eng, run, reqs,
                    make="paged_continuous" if engine == "paged"
                    else "continuous",
                    slots=8, seed=0, async_steps=async_steps)
    torch.cuda.synchronize()
    rep["wall_s"] = time.perf_counter() - clock.t_wall
    return rep


def _steady_steps(eng, engine: str, async_steps: bool) -> dict:
    """Steady decode steps as the batcher takes them (8 prompt-less greedy
    requests of 400 tokens, 10 steps in), sync or async: host wall per step
    over 50 steps without the profiler (which inflates the host's Python
    time), device busy per step from ``torch.profiler`` over 20 more, and
    the step's idle share, 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.scheduler import Request

    cb = (eng.paged_continuous if engine == "paged" else eng.continuous)(
        slots=8, async_steps=async_steps)
    cb.admit([Request(rid=i, new_tokens=400, first_token=i + 1)
              for i in range(8)], now=0.0)
    for _ in range(10):
        cb.step(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        cb.step(0.0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            cb.step(0.0)
        torch.cuda.synchronize()
    busy = sum(_kernel_ms(prof, 20).values()) or None
    cb.flush(0.0)
    idle = None if busy is None else 1.0 - busy / wall_ms
    log(f"[async:{engine}] steady decode step, async_steps={async_steps} (8 "
        f"slots, positions 10-90): wall {wall_ms:.3f} ms per step (50 steps, "
        f"no profiler), device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms (profiler, 20 steps), idle share "
           f"{100 * idle:.1f}%") + f" | {_card()}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle}


def async_phase(cfg, params) -> dict:
    """The async step pipeline against the synchronous loop at full width
    (olmo-1b bf16, graph targets): the paged bf16 cell's stream and dense
    cell (a)'s, each run sync then async on one engine under a
    ``_BatcherClock``: every token equal (sampled ones too), the same steps
    and lane calls, 0 captures after warmup, in-flight depth >= 2 on the
    async run; wall tok/s over the same schedule, ``host_plan_ms`` and
    ``device_wait_ms`` printed for both, then a steady decode step's idle
    share both ways."""
    from repro_torch.runtime.serve import Engine, EngineConfig

    cells = {
        "paged": (dict(max_len=1024, max_batch=8, page_size=16,
                       prefill_chunk=64), _shared_prefix_traffic),
        "continuous": (dict(max_len=1024, max_batch=8, prefill_chunk=64),
                       _continuous_traffic),
    }
    out = {}
    for engine, (ecfg, traffic) in cells.items():
        _release_engines()
        t0 = time.perf_counter()
        runs = {}
        with Engine(cfg, params, EngineConfig(**ecfg)) as eng:
            check(eng.graphs, f"async {engine}: targets are not CUDA graphs")
            for mode in (False, True):
                reqs = traffic(cfg)
                rep = _async_stream(eng, engine, reqs, mode)
                _check_stream(f"async {engine}/{mode}", cfg, reqs, rep)
                check(rep["compiles_after_warmup"] == 0,
                      f"async {engine} async_steps={mode}: "
                      f"{rep['compiles_after_warmup']} captures after warmup")
                runs[mode] = (reqs, rep)
            idle = {mode: _steady_steps(eng, engine, mode)
                    for mode in (False, True)}
        (sreqs, srep), (areqs, arep) = runs[False], runs[True]
        check([r.tokens for r in sreqs] == [r.tokens for r in areqs],
              f"async {engine}: async tokens != synchronous tokens")
        # run-ahead issues a decode step past a stream's last token when
        # the step before it was chainable (the JAX package's pipeline
        # does the same): the decode lane may take those extra calls, no
        # other lane differs
        lane = "cbp" if engine == "paged" else "cb"
        extra = arep["steps"] - srep["steps"]
        calls = dict(arep["lane_calls"])
        calls[lane] = calls.get(lane, 0) - extra
        check(extra >= 0 and calls == srep["lane_calls"],
              f"async {engine}: steps/lane calls {arep['steps']} "
              f"{arep['lane_calls']} vs sync {srep['steps']} "
              f"{srep['lane_calls']}")
        check(arep["pipeline"]["inflight_depth"] >= 2,
              f"async {engine}: in-flight depth "
              f"{arep['pipeline']['inflight_depth']}")
        sampled = sum(not r.greedy for r in areqs)
        line = {}
        for mode, (_, rep) in runs.items():
            p = rep["pipeline"]
            line[mode] = {"tok_per_s_wall": rep["tokens"] / rep["wall_s"],
                          "wall_s": rep["wall_s"], "steps": rep["steps"],
                          "host_plan_ms": p["host_plan_ms"],
                          "device_wait_ms": p["device_wait_ms"],
                          "d2h_transfers": p["d2h_transfers"],
                          "inflight_depth": p["inflight_depth"]}
        log(f"[async:{engine}] olmo-1b bf16, {len(areqs)} requests "
            f"({sampled} sampled), {arep['tokens']} tokens, {srep['steps']} "
            f"steps sync, lane calls {srep['lane_calls']}: async = sync on "
            f"every token and lane call, +{extra} run-ahead decode step(s) "
            f"past the last token, 0 captures after warmup | sync: "
            f"{line[False]['tok_per_s_wall']:.1f} tok/s over "
            f"{line[False]['wall_s']:.3f}s of steps, host_plan_ms "
            f"{line[False]['host_plan_ms']}, device_wait_ms "
            f"{line[False]['device_wait_ms']}, d2h {line[False]['d2h_transfers']}"
            f" | async: {line[True]['tok_per_s_wall']:.1f} tok/s over "
            f"{line[True]['wall_s']:.3f}s, host_plan_ms "
            f"{line[True]['host_plan_ms']}, device_wait_ms "
            f"{line[True]['device_wait_ms']}, d2h {line[True]['d2h_transfers']}"
            f", in-flight depth {line[True]['inflight_depth']} | speedup "
            f"{line[True]['tok_per_s_wall'] / line[False]['tok_per_s_wall']:.3f}"
            f" | phase {time.perf_counter() - t0:.1f}s | {_card()}")
        out[engine] = {"sync": line[False], "async": line[True],
                       "idle": idle}
    return out


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


def _into_burst_cache(eng, bucket: int, cache: list) -> list:
    """Copy a prompt's cache into the bucket's burst cache, the one its
    graph targets were captured over (after ``set_mode``, whose warm run
    writes it)."""
    dst = eng.burst_cache(bucket)
    for d, c in zip(dst, cache, strict=True):
        for k, t in c.items():
            d[k].copy_(t)
    return dst


def prompt_then_burst(cfg, params, moe_policy: str = "drop",
                      hold: bool = True, logit_tol: float | None = None,
                      b: int = 8, prompt_len: int = 256,
                      max_len: int = 1024) -> dict:
    """``prefill`` (B6) of ``b`` prompts of ``prompt_len`` (8 of 256),
    ``pad_cache`` to ``max_len``, then
    ``set_mode``, the cache copied into the bucket's burst cache, and
    ``decode_loop`` of 32 greedy tokens (B5, a graph replay a step) — the
    JAX package's prefill-then-decode sequence — and ``forward`` (B6) over
    prompt + tokens, with the counts set to 0 just before and read after;
    a hybrid stack's mamba layers run B8 in ``prefill`` and ``forward``.
    Then ``forward`` with B6 against the naive attention on the same
    tokens, and a profiled window of burst steps. A MoE stack runs
    ``prefill`` and ``forward`` under ``moe_policy``: "dense" drops
    nothing, as the burst's one-token steps never do under "drop", so the
    three agree; "drop" over 256 or 288 tokens would drop by those calls'
    capacities. The tie margin and the B6-vs-naive tolerance are
    ``STEP_LOGIT_ATOL`` in bf16 and ``FP32_LOGIT_ATOL`` in fp32 (the
    latter ``logit_tol`` where given). With
    ``hold`` False the path's launches and finite logits are held and the
    two comparisons only logged: granite-moe's random bf16 weights turn
    any two roundings into other tokens (its fp32 run holds them)."""
    from repro_torch import kernels, models
    from repro_torch.runtime import steps
    from repro_torch.runtime.serve import GREEDY, Engine, EngineConfig

    margin = STEP_LOGIT_ATOL if cfg.dtype == "bfloat16" else FP32_LOGIT_ATOL
    logit_tol = margin if logit_tol is None else logit_tol
    held = "" if hold else " (logged, not held)"
    n = 32
    attn = _attention_layers(cfg)
    mamba = cfg.num_layers - attn
    expect = ("flash_attention", "decode_attention") + (
        ("ssd_chunk",) if mamba else ())
    g = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=g,
                            dtype=torch.int32).to("cuda")
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    last, cache = steps.make_prefill_fn(cfg, moe_policy=moe_policy)(
        params, prompts)
    cache = models.pad_cache(cfg, cache, max_len)
    first = last.argmax(-1).to(torch.int32)[:, None]
    with Engine(cfg, params, EngineConfig(max_len=max_len, max_batch=b,
                                          batch_quantum=min(b, 4))) as eng:
        eng.set_mode(batch=b, sampling=GREEDY)
        cache = _into_burst_cache(eng, b, cache)
        toks, cache = eng.decode_loop(cache, first, prompt_len, n)
        seq = torch.cat([prompts, first,
                         torch.from_numpy(toks[:, :-1]).to("cuda")], dim=1)
        logits, _ = models.forward(cfg, params, seq, moe_policy=moe_policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches("prompt+burst", expect)
        check(launches["flash_attention"] == 2 * attn,
              f"prompt+burst: B6 launched {launches['flash_attention']} "
              f"times, expected one per attention layer for prefill and for "
              f"forward")
        check(launches["ssd_chunk"] == 2 * mamba,
              f"prompt+burst: B8 launched {launches['ssd_chunk']} times, "
              f"expected one per mamba layer for prefill and for forward")
        check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
        gen = logits[:, prompt_len:].float()  # predicts toks[:, i]
        chosen = torch.from_numpy(toks).to("cuda").long()
        lead = gen.max(-1).values - gen.gather(-1, chosen[..., None])[..., 0]
        flips = int((lead > 0).sum())
        check(not hold or bool((lead < margin).all()),
              f"prompt+burst: forward's top logit leads the burst's token by "
              f"{lead.max().item():.4f}")
        log(f"[prompt+burst] {cfg.name}: prefill {b}x{prompt_len} (B6), "
            f"pad_cache to "
            f"{max_len}, decode_loop {n} greedy tokens (B5), forward over "
            f"{seq.shape[1]} tokens (B6) in {wall:.2f}s: argmax agrees at "
            f"{b * n - flips}/{b * n} generated positions ({cfg.dtype}); "
            f"{flips} flips, max lead {lead.max().item():.4f} (margin "
            f"{margin}{held}; {int(((lead > 0) & (lead < TIE_MARGIN)).sum())}"
            f" under {TIE_MARGIN}) | launches {launches}")
        naive, _ = models.forward(cfg, params, seq, impl="naive",
                                  moe_policy=moe_policy)
        err = (logits - naive).abs().max().item()
        agree = (logits.argmax(-1) == naive.argmax(-1)).float().mean().item()
        log(f"[prompt+burst] {cfg.name}: forward B6 vs naive attention: "
            f"logits max abs "
            f"diff {err:.4f} (tolerance {logit_tol}{held}; |logits| max "
            f"{naive.abs().max().item():.2f}), argmax agreement {agree:.3f}")
        check(not hold or err <= logit_tol,
              f"forward: B6 vs naive differ by {err}")
        del logits, naive
        exe = eng._current
        tok = torch.from_numpy(toks[:, -1:]).to("cuda")
        pos = torch.tensor(prompt_len + n, dtype=torch.int32, device="cuda")
        key = torch.zeros(2, dtype=torch.int32, device="cuda")
        _profile(f"full-width burst step (dense cache, {b} rows, pos "
                 f"{prompt_len + n})", lambda: exe(cache, tok, pos, key), 5,
                 "dense_decode_split_kernel")
    return launches


def _kernel_ms(prof, calls: int, counts: dict | None = None) -> dict:
    """{kernel name: device ms per call} of a profile over ``calls`` calls;
    ``counts``, when given, receives {kernel name: launches recorded}."""
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type.name == "CUDA":
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3 / calls
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count
    return by_name


def _profile(label: str, run, steps: int, attn_kernel: str) -> dict:
    """Device kernel time by name (``torch.profiler``) over ``steps`` calls
    of ``run`` against their host wall time; returns {kernel: ms per call}
    (empty when the profiler recorded no kernels)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = _kernel_ms(prof, steps)
    busy = sum(by_name.values())
    if busy == 0:
        log(f"[profile] {label}: device time not measured (profiler recorded "
            f"no CUDA kernels); host wall {wall_ms:.2f} ms/step")
        return by_name
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if attn_kernel in k)
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%), "
        f"{attn_kernel} {attn:.3f} ms ({100 * attn / busy:.1f}% of busy); "
        f"top kernels: "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    return by_name


def profile_steps(cfg, params) -> None:
    """Where a full-width step's time goes: a decode step on bf16 and on
    int8 pages (8 slots at position 200, 256-token tables; B1's and B3's
    share), a speculative step on int8
    pages (a 2-layer int8 draft proposing 4 tokens, then a 5-row verify
    with the table at the 64-page cap), and a `pf` step on bf16 and on int8
    pages (B2's and B4's share)."""
    from repro_torch import models
    from repro_torch.kernels.decode_attention import decode_splits
    from repro_torch.runtime import steps as steps_mod

    dev, slots, pb, ps = "cuda", 8, 16, 16
    bt = torch.arange(1, slots * pb + 1, dtype=torch.int32,
                      device=dev).view(slots, pb)
    pos = torch.full((slots,), 200, dtype=torch.int32, device=dev)
    tok = torch.zeros(slots, 1, dtype=torch.int32, device=dev)
    splits = decode_splits(slots, cfg.num_kv_heads,
                           cfg.num_heads // cfg.num_kv_heads, pb)
    for kv_dtype, kernel in (("fp32", "B1"), ("int8", "B3")):
        cache = models.init_paged_cache(cfg, slots * pb + 1, ps, kv_dtype,
                                        device=dev)
        pages = "bf16" if kv_dtype == "fp32" else "int8"
        _profile(f"full-width decode step ({pages} pages, {slots} slots, pos "
                 f"200; {kernel}, S {splits})",
                 lambda: models.paged_decode_step(cfg, params, cache, tok, pos,
                                                  bt),
                 5, "paged_decode_split_kernel")
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
    keys = _row_keys(slots, dev)
    length = torch.full((slots,), k + 1, dtype=torch.int32, device=dev)

    def spec_step():
        drafts = draft(dparams, dcache, tok, pos, active, temps, active,
                       keys)[0]
        window = torch.cat([tok, drafts], dim=1)
        return verify(params, cache8, window, pos, btf, length, temps, active,
                      keys)

    _profile("full-width spec step (int8 pages, draft 2 layers x k 4 + "
             "5-row verify, 8 slots, pos 200)", spec_step, 5,
             "paged_prefill_tc_kernel")
    del cache8, dcache
    # one `pf` step of each paged cell: 8 rows x chunk 64 at starts 0-192
    # (keys < 256), tables at the 64-page cap
    c = 64
    st = torch.tensor([0, 64, 128, 192] * 2, dtype=torch.int32, device=dev)
    length = torch.full((slots,), c, dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(9)
    chunk = torch.randint(0, cfg.vocab_size, (slots, c), generator=g,
                          dtype=torch.int32).to(dev)
    for kv_dtype, kernel in (("fp32", "B2"), ("int8", "B4")):
        pcache = models.init_paged_cache(cfg, slots * cap + 1, ps, kv_dtype,
                                         device=dev)
        pages = "bf16" if kv_dtype == "fp32" else "int8"
        _profile(f"full-width pf step ({pages} pages, {slots} rows x chunk "
                 f"{c}, starts 0-192; {kernel})",
                 lambda: models.paged_prefill_step(cfg, params, pcache, chunk,
                                                   st, btf, length),
                 5, "paged_prefill_tc_kernel")
        del pcache


# ------------------------------------------------------------------ phase 5
def _near_tie(cfg, params, seq, kv_dtype: str) -> bool:
    """Top-2 margin of the greedy logits after ``seq`` (one plain chunked
    prefill on the CPU, pages of ``kv_dtype``; ``forward`` for a stack
    with mamba layers) is under ``TIE_MARGIN``."""
    from repro_torch import models

    if any(cfg.mixer_at(s) == "mamba" for s in range(cfg.period)):
        logits, _ = models.forward(
            cfg, params, torch.tensor([seq], dtype=torch.int32),
            impl="naive", moe_policy=_tie_policy(cfg))
        top2 = logits[0, -1].topk(2).values
        return float(top2[0] - top2[1]) < TIE_MARGIN
    ps = 8
    n = -(-len(seq) // ps)
    cache = models.init_paged_cache(cfg, n + 1, ps, kv_dtype)
    logits, _ = models.paged_prefill_step(
        cfg, params, cache, torch.tensor([seq], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.arange(1, n + 1, dtype=torch.int32)[None],
        torch.tensor([len(seq)], dtype=torch.int32), attn_impl="plain",
        moe_policy=_tie_policy(cfg),
    )
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1]) < TIE_MARGIN


def smoke_card_vs_cpu() -> dict:
    """The smoke config (fp32, TF32 off), a third of the requests sampled:
    card (graph targets) = CPU for the plain stream and for speculation on
    model-dtype and on int8 pages, under one step clock, sampled tokens
    included (threefry keys: the kernel on the card, ``prng`` on the CPU);
    each spec stream's greedy requests equal its pool's plain stream up to
    a near-tie (a sampled request's keys split once per step, and the two
    schedules take different steps)."""
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
                tokens_mean=8, total_max=64, sample_frac=1 / 3,
                vocab=cfg.vocab_size,
            )
            ecfg = EngineConfig(max_len=64, max_batch=4, page_size=8,
                                num_pages=40, prefill_chunk=16,
                                kv_dtype=kv_dtype, spec_k=spec_k,
                                draft_kv_dtype=kv_dtype)
            kernels.reset_launch_counts()
            with Engine(cfg, params, ecfg, device=dev) as eng:
                rep = run_paged_stream(eng, reqs, slots=4, clock=_StepClock())
                warm_vf = len(eng._k_buckets())
                chunks = len(eng._chunk_buckets())
                draft_layers = eng.draft_cfg.num_layers if spec_k else 0
                check(eng.graphs == (dev == "cuda"),
                      f"smoke {dev}: cuda_graphs {eng.graphs}")
            tag = f"{kv_dtype}/spec_k={spec_k}/{dev}"
            check(rep["finished"] == len(reqs)
                  and rep["compiles_after_warmup"] == 0,
                  f"smoke stream {tag}: {rep['finished']} finished, "
                  f"{rep['compiles_after_warmup']} compiles after warmup")
            if spec_k:
                check(rep["lane_steps"]["verify"] > 0, f"{tag}: no verify")
            if spec_k and kv_dtype == "fp32" and dev == "cuda":
                # B2 serves the pf and vf lanes and the draft's drp, one
                # launch per layer per call, each warmed key's runs included
                n = kernels.paged_prefill_attention.launches
                steps = rep["lane_steps"]
                runs = _warm_runs_per_key()
                want = cfg.num_layers * (
                    steps["prefill"] + runs * chunks
                    + steps["verify"] + runs * warm_vf
                ) + draft_layers * (rep["lane_calls"]["drp"] + runs * chunks)
                check(n == want, f"{tag}: B2 launched {n}, expected {want}")
                b2_verify = {"launches": cfg.num_layers
                             * (steps["verify"] + runs * warm_vf),
                             "verify_steps": steps["verify"]}
            streams[tag] = {r.rid: (r.prompt, r.tokens, r.greedy)
                            for r in reqs}
    for kv_dtype in ("fp32", "int8"):
        for spec_k in (0, 2):
            a = streams[f"{kv_dtype}/spec_k={spec_k}/cuda"]
            b = streams[f"{kv_dtype}/spec_k={spec_k}/cpu"]
            check(a == b, f"smoke {kv_dtype}/spec_k={spec_k}: card != CPU")
        plain = streams[f"{kv_dtype}/spec_k=0/cpu"]
        spec = streams[f"{kv_dtype}/spec_k=2/cpu"]
        ties = 0
        sampled = sum(not g for _, _, g in plain.values())
        check(sampled > 0, f"smoke {kv_dtype}: no sampled request")
        for rid, (prompt, toks, greedy) in plain.items():
            if not greedy:
                continue
            other = spec[rid][1]
            diff = [i for i, (x, y) in enumerate(zip(toks, other)) if x != y]
            if diff:
                check(_near_tie(
                    cfg, params, list(prompt) + toks[:diff[0]], kv_dtype),
                    f"smoke {kv_dtype}: spec stream differs at rid {rid}")
                ties += 1
            else:
                check(toks == other, f"smoke {kv_dtype}: rid {rid} length")
        n = sum(len(t) for _, t, _ in plain.values())
        log(f"[smoke] {kv_dtype} pages: card = CPU with and without "
            f"speculation, {sampled} of {len(plain)} requests sampled; spec = "
            f"plain stream on the greedy ones ({n} tokens, {ties} near-tie "
            f"divergences)")
    streams = {}
    for graphs in (True, False):
        reqs = shared_prefix_arrivals(
            12, 1000.0, seed=2, num_prefixes=3, prefix_len=20,
            tokens_mean=8, total_max=64, sample_frac=0.5,
            vocab=cfg.vocab_size,
        )
        with Engine(cfg, params, EngineConfig(
            max_len=64, max_batch=4, page_size=8, num_pages=40,
            prefill_chunk=16, spec_k=2, cuda_graphs=graphs)) as eng:
            rep = run_paged_stream(eng, reqs, slots=4, seed=3,
                                   clock=_StepClock())
        check(rep["finished"] == len(reqs) and rep["compiles_after_warmup"]
              == 0, f"smoke sampled graphs={graphs}: {rep['finished']} "
              f"finished, {rep['compiles_after_warmup']} captures after "
              f"warmup")
        streams[graphs] = {r.rid: r.tokens for r in reqs}
    check(streams[True] == streams[False],
          "smoke sampled stream: graph targets != eager targets (seed 3)")
    log(f"[smoke] sampled stream (half the requests sampled, seed 3, "
        f"speculation on): graph targets = eager targets token for token "
        f"({sum(len(t) for t in streams[True].values())} tokens)")
    log(f"[smoke] B2 through the verify lane: {b2_verify['launches']} launches "
        f"({b2_verify['verify_steps']} verify replays x {cfg.num_layers} "
        f"layers, warmup runs included)")
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
# y's rms error over y's rms, both types: a second guard on the tensor-core
# body's bf16 products. Its split G puts ~1e-4 there, one rounding of G
# ~3e-3, which the max-over-max limit above lets through.
SSD_Y_RMS_TOL = 1e-3
# The B8 cases: the smoke config's heads (8 of 16, state 16) at the chunks
# the JAX package's kernel tests use, a ragged 20; and mamba2-370m's (32 of
# 64, state 128, chunk 256) at two rows of 1024, ragged 1056, and the
# tensor-core body's edges: one row, one short of / exactly / one past a
# chunk, and eight chunks.
SSD_CASES = [(2, s, 8, 16, 16, chunk) for chunk in (4, 8, 16)
             for s in (16, 32, 20)] + [(2, s, 32, 64, 128, 256)
                                       for s in (1, 255, 256, 257, 1024,
                                                 1056, 2048)]


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


def _ssd_y_rms(y, ref_y) -> float:
    """y's rms error over the rms of the reference y."""
    ref = ref_y.float()
    return ((y.float() - ref).pow(2).mean().sqrt()
            / ref.pow(2).mean().sqrt()).item()


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
            rms = _ssd_y_rms(out[0], ref[0])
            tag = f"L={chunk}/S={s}/P={p}/N={n}/{str(dtype)[6:]}"
            worst[tag] = (ey, es, rms)
            check(ey <= SSD_REL_TOL[dtype] and es <= SSD_STATE_REL_TOL,
                  f"ssd_chunk {tag}: relative max err y {ey:.3g}, state "
                  f"{es:.3g} > {SSD_REL_TOL[dtype]}, {SSD_STATE_REL_TOL}")
            check(rms <= SSD_Y_RMS_TOL,
                  f"ssd_chunk {tag}: y's relative rms err {rms:.3g} > "
                  f"{SSD_Y_RMS_TOL}")
    for dtype in ("float32", "bfloat16"):
        errs = {k: v for k, v in worst.items() if k.endswith(dtype)}
        log(f"[ssd] {len(errs)} {dtype} B8 cases pass (ragged S and stride-0 "
            f"B/C included): max relative err y "
            f"{max(e[0] for e in errs.values()):.3g}, state "
            f"{max(e[1] for e in errs.values()):.3g}, y rms "
            f"{max(e[2] for e in errs.values()):.3g} (tolerance "
            f"{SSD_REL_TOL[getattr(torch, dtype)]}, {SSD_STATE_REL_TOL}, "
            f"{SSD_Y_RMS_TOL})")
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
        cache = _into_burst_cache(eng, b, padded)
        toks, cache = eng.decode_loop(cache, first, prompt_len, n)
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
        for _ in range(3):  # a profile has on some runs recorded nothing
            by_name = _profile(
                f"full-width mamba2 prefill ({b}x{prompt_len}, B8)",
                lambda: models.prefill(cfg, params, prompts), 2,
                "ssd_chunk_tc_kernel")
            if by_name:
                break
        if not by_name:  # a second witness: one B8 call at a prefill layer's shape
            ssd_args = _ssd_inputs(b, prompt_len, cfg.ssm_heads,
                                   cfg.ssm_headdim, cfg.ssm_state,
                                   torch.bfloat16, seed=5)
            by_name = _profile(
                "one B8 call at the prefill shape",
                lambda: kernels.ssd_chunk(*ssd_args, chunk=cfg.ssm_chunk), 1,
                "ssd_chunk_tc_kernel")
        if by_name:
            check(any("ssd_chunk_tc_kernel" in k for k in by_name)
                  and not any("ssd_chunk_kernel" in k for k in by_name),
                  f"mamba prefill: the profile does not show the tensor-core "
                  f"B8 kernel alone ({sorted(by_name)[:8]})")
        else:
            log("[mamba prompt+burst] B8's route not profiled (the profiler "
                "recorded no kernels four times); the launch count above and "
                "tests/test_torch_ssd_tc.py's source test pin it")
        exe = eng._current
        tok = torch.from_numpy(toks[:, -1:]).to("cuda")
        pos = torch.tensor(prompt_len + n, dtype=torch.int32, device="cuda")
        key = torch.zeros(2, dtype=torch.int32, device="cuda")
        _profile(f"full-width mamba2 burst step ({b} rows, recurrent state)",
                 lambda: exe(cache, tok, pos, key), 5, "ssd_chunk_tc_kernel")
    return launches


# mamba2's graphs-vs-eager twin on 12 of its 48 layers (its eager run was
# 30 s of the script at 48); its counted stream and profiles keep all 48.
MAMBA_TWIN_LAYERS = 12


def mamba_full_width() -> dict:
    """mamba2-370m at full width (48 layers, bf16, seeded weights): the
    prompt-then-burst path through B8, then the olmo burst cell's traffic
    through the per-burst engine on the recurrent state (graphs against
    eager on the first ``MAMBA_TWIN_LAYERS`` layers)."""
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
    burst_stream(cfg, params, "mamba burst", ("sample_rows",))
    from repro_torch.runtime.serve import Engine, EngineConfig

    burst = dict(max_len=1024, max_batch=8, batch_quantum=4)
    tcfg, tparams = _depth_view(cfg, params, MAMBA_TWIN_LAYERS, "mamba")
    _paired_streams("mamba burst", tcfg, tparams, burst,
                    partial(_burst_traffic, tcfg), "burst")
    del tparams
    runs, engines = {}, []
    for mode in ("graph", "eager"):
        eng = Engine(cfg, params, EngineConfig(**burst,
                                               cuda_graphs=mode == "graph"))
        engines.append(eng)
        runs[mode] = _burst_run(eng, 8, 32)
    _profile_replay("mamba2 burst (8 rows, recurrent state)", runs)
    for eng in engines:
        eng.close()
    return launches


def mamba_smoke_card_vs_cpu() -> None:
    """The mamba2 smoke config (fp32, TF32 off), a third of the requests
    sampled: the burst stream's tokens on the card equal the CPU's under
    one virtual clock."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import poisson_arrivals
    from repro_torch.runtime.serve import Engine, EngineConfig, run_burst_stream

    cfg = get_config("mamba2-370m").smoke()
    params = models.init_params(cfg, seed=0)
    streams, reports = {}, {}
    for dev in ("cuda", "cpu"):
        reqs = poisson_arrivals(12, 50.0, seed=4, tokens_mean=8,
                                tokens_max=32, sample_frac=1 / 3,
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
    log(f"[smoke] mamba2 burst stream (a third sampled): card = CPU "
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


def _queued_ms(fn, flush, runs: int) -> float | None:
    """Device time per call of ``fn`` from CUDA events around ``runs`` calls
    queued behind a device sleep, so that the host has enqueued every call
    before the first one starts and its time drops out; the L2 flush before
    each call is timed the same way alone and taken off. None when the
    sleep ended before the host had enqueued the calls."""
    def span(body) -> float | None:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's 1.98 GHz
        a.record()
        for _ in range(runs):
            body()
        b.record()
        queued = not a.query()
        b.synchronize()
        return a.elapsed_time(b) if queued else None

    both = span(lambda: (flush.zero_(), fn()))
    alone = span(flush.zero_)
    if both is None or alone is None:
        return None
    return (both - alone) / runs


def _device_ms(fn, kernel: str, runs: int = 30) -> tuple[float | None,
                                                        float | None]:
    """Device time per call of ``fn``, without the host time ``_median_ms``
    includes, with L2 flushed before each call (the flush not counted), two
    ways: ``torch.profiler`` (the kernels whose name holds ``kernel``; up to
    three tries, as a profile has on some runs recorded none or only some
    of the ``runs`` launches, and only a try that recorded all of them
    counts) and ``_queued_ms``. Either is None where it measured nothing."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    profiled = None
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        counts = {}
        ms = sum(v for k, v in _kernel_ms(prof, runs, counts).items()
                 if kernel in k)
        # a profile that dropped some of the kernels' events would divide
        # their time by too many calls: take only one that kept them all
        if ms > 0 and sum(n for k, n in counts.items() if kernel in k) == runs:
            profiled = ms
            break
    return profiled, _queued_ms(fn, flush, runs)


def _fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _device_only(fn, call, kernel: str) -> dict:
    """``_device_ms`` of ``call``, a call of the wrapper ``fn`` (the
    profiler's kernels whose name holds ``kernel``), failing if neither way
    measured anything; timing launches are not main-path launches, so
    ``fn``'s count is kept."""
    saved = fn.launches
    profiled_ms, queued_ms = _device_ms(call, kernel)
    fn.launches = saved
    check(profiled_ms is not None or queued_ms is not None,
          f"{fn.__name__}: neither the profiler nor CUDA events measured its "
          f"device time")
    device_ms, device_by = ((profiled_ms, "profiler")
                            if profiled_ms is not None
                            else (queued_ms, "cuda events"))
    return {"device_ms": device_ms, "device_ms_by": device_by,
            "profiled_ms": profiled_ms, "queued_ms": queued_ms}


def time_kernels(launches: dict, b2_verify: dict,
                 by_path: dict) -> list[dict]:
    """B1-B4 at the main paths' shapes. ``launches`` holds each kernel's
    count on its paged main path; ``by_path`` every serving path's counts
    (the paged cells, the dense continuous streams), each set to 0 just
    before its path and read just after."""
    import torch.nn.functional as F

    from repro_torch import kernels, roofline
    from repro_torch.kernels.decode_attention import decode_splits

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
        """Least time for the call (``roofline.paged_attention_work``):
        each visible K/V row read once (and its scale, for int8), q read,
        out written; or its flops at bf16 peak."""
        return roofline.bound_ms(roofline.paged_attention_work(
            dh=dh, pairs=pairs, kv_tokens=kv_tokens, kv_row_bytes=kv_bytes,
            io_bytes=(q.numel() * q.element_size()
                      + out.numel() * out.element_size()
                      + sum(t.numel() * 4 for t in ints)),
        ), dtype)

    def gathered(pages, bt, length, scale=None):
        """Pages of each row as [B, KH, L, dh] in q's dtype (dequantised
        first for int8) — the library call's inputs, made before timing."""
        g_ = pages[bt[:, : length // ps]].float()
        if scale is not None:
            g_ = g_ * scale[bt[:, : length // ps]][..., None, None]
        return g_.reshape(bt.shape[0], length, kh, dh).transpose(1, 2).to(
            dtype).contiguous()

    def decode_case(int8: bool, pb: int = 16, lo: int = 96):
        # B1/B3 at the decode lane's shapes: 8 slots, pages bucket 16,
        # positions lo..pb*ps-1
        bt = perm[: slots * pb].view(slots, pb).to(torch.int32).to(dev)
        pos = torch.randint(lo, pb * ps, (slots,), generator=g,
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

    def split_sweep(fn, int8: bool) -> dict:
        """B1/B3 device-only at every S 1-8, at the timing shape and on
        rows of 48-64 pages (a 64-page bucket): the evidence for
        ``decode_splits``. All by queued CUDA events, one method for every
        S. Timing launches are not main-path launches."""
        sweep, saved = {}, fn.launches
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        for pb, lo in ((16, 96), (64, 768)):
            args = decode_case(int8, pb, lo)[0]
            by_s = {}
            for s_ in range(1, 9):
                call = partial(fn, *args, splits=s_)
                for _ in range(5):
                    call()
                by_s[s_] = _queued_ms(call, flush, 30)
            pick = decode_splits(slots, kh, h // kh, pb)
            log(f"[timing] {fn.__name__} device-only ms by S (queued "
                f"events), pages bucket {pb} (positions {lo}-{pb * ps - 1}; "
                f"decode_splits picks {pick}): "
                + ", ".join(f"S {k} {_fmt_ms(v)}" for k, v in by_s.items()))
            sweep[pb] = by_s
        fn.launches = saved
        return sweep

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
        split = {}
        if "decode" in fn.__name__:  # B1/B3: the wrapper's cluster size
            split = {"splits": decode_splits(slots, kh, h // kh,
                                             args[-2].shape[1])}
        out = fn(*args)
        ref = plain(args[0].float(), *args[1:])
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        check(err <= KERNEL_ATOL[dtype], f"{fn.__name__} at main-path shapes "
              f"q{tuple(args[0].shape)}: max abs err {err:.3g}")
        saved = fn.launches  # timing launches are not main-path launches
        ms = _median_ms(lambda: fn(*args))
        fn.launches = saved
        dev = _device_only(fn, lambda: fn(*args), "paged_")
        plain_ms = _median_ms(lambda: plain(*args))
        library_ms = _median_ms(library)
        bound_ms, bound_by = bound(kv_tokens, pairs, args[0], out,
                                   args[-2:], kv_row)
        log(f"[timing] {fn.__name__} bf16 q{tuple(args[0].shape)} pages "
            f"{tuple(args[1].shape)} {args[1].dtype} table "
            f"{tuple(args[-2].shape)}"
            + (f" S {split['splits']}" if split else "")
            + f": kernel {ms:.4f} ms per call (device "
            f"only {_fmt_ms(dev['profiled_ms'])} profiled, "
            f"{_fmt_ms(dev['queued_ms'])} by queued events), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), max abs err {err:.3g}")
        return {**split, "max_abs_err": err, "ms": ms, **dev,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    rows = []
    for fn, plain, replaces, kv_row, case, verify in cases:
        source = "src/repro_torch/csrc/" + (
            "paged_attention_int8.cu" if "int8" in fn.__name__
            else "paged_attention.cu")
        row = {"name": fn.__name__, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[fn.__name__],
               "launches_by_path": {path: counts.get(fn.__name__, 0)
                                    for path, counts in by_path.items()},
               **measure(fn, plain, kv_row, case)}
        if verify is not None:  # the same kernel at the verify window
            row.update({f"verify_{k}": v for k, v in
                        measure(fn, plain, kv_row, verify).items()})
        if fn is kernels.paged_prefill_attention:
            row["verify_launches"] = b2_verify["launches"]  # smoke, phase 5
        if "decode" in fn.__name__:
            row["device_ms_by_splits"] = split_sweep(fn, "int8" in fn.__name__)
        rows.append(row)
    return rows


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def time_sampling(launches: dict, by_path: dict) -> list[dict]:
    """``sample_rows`` at the serving shapes (``SAMPLE_SHAPES``, float32 —
    the steps' logits — and bfloat16): per call with its host time,
    device-only, the plain version, the old noise tail (``torch.rand`` +
    ``argmax(logits / t - log(-log(u)))`` + the greedy ``argmax`` and
    ``where``, the draw the steps made before threefry) and the bound:
    ``max(bytes / HBM rate, int32 ops / (132 SMs x 64 lanes x the max SM
    clock))``, the ops counted for this data (sampled rows draw, greedy
    rows only rank). The row's numbers are olmo-1b's shape, 8 x 50304
    float32."""
    from repro_torch import kernels, roofline
    from repro_torch.kernels import sampling

    clock_hz = _sm_clock_hz()
    fn = kernels.sample_rows
    shapes = []
    for rows, vocab in SAMPLE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            logits, temps, greedy, keys = _sampling_inputs(rows, vocab, dtype,
                                                           seed=vocab + rows)

            def call(logits=logits, temps=temps, greedy=greedy, keys=keys):
                return fn(logits, temps, greedy, keys)

            def old(logits=logits, temps=temps, greedy=greedy):
                u = torch.rand(logits.shape, device="cuda")
                t = temps.clamp_min(1e-4)[:, None].to(logits.dtype)
                first = logits.argmax(dim=-1).to(torch.int32)
                drawn = (logits / t - torch.log(-torch.log(u))).argmax(dim=-1)
                return torch.where(greedy, first, drawn.to(torch.int32))

            scores = torch.empty(rows, vocab, device="cuda")
            saved = fn.launches  # timing launches are not main-path launches
            fn(logits, temps, greedy, keys, scores=scores)
            err = (scores - sampling.sample_scores_plain(
                logits, temps, greedy, keys)).abs().max().item()
            ms = _median_ms(call)
            fn.launches = saved
            dev = _device_only(fn, call, "sample_rows_kernel")
            plain_ms = _median_ms(lambda: sampling.sample_rows_plain(
                logits, temps, greedy, keys))
            old_ms = _median_ms(old)
            drawn_rows = int((~greedy).sum())
            work = roofline.sample_rows_work(
                rows=rows, vocab=vocab, elt=logits.element_size(),
                drawn_rows=drawn_rows)
            nbytes, ops = work.bytes, work.int_ops
            bound_ms, bound_by = roofline.bound_ms(work, clock_hz=clock_hz)
            tag = f"{rows}x{vocab} {str(dtype)[6:]}"
            log(f"[timing] sample_rows {tag} ({drawn_rows} rows sampled): "
                f"kernel {ms:.4f} ms per call (device only "
                f"{_fmt_ms(dev['profiled_ms'])} profiled, "
                f"{_fmt_ms(dev['queued_ms'])} by queued events), plain "
                f"(prng, torch ops) {plain_ms:.4f} ms, old noise tail "
                f"{old_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M int32 ops at "
                f"{clock_hz / 1e6:.0f} MHz), scores max abs err {err:.3g}")
            shapes.append({"shape": tag, "ms": ms, **dev, "plain_ms": plain_ms,
                           "old_tail_ms": old_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "max_abs_err": err})
    main = shapes[0]  # olmo-1b: 8 x 50304 float32
    return [{"name": "sample_rows", "route": "cuda",
             "source": "src/repro_torch/csrc/sample_rows.cu",
             "replaces": "src/repro/runtime/steps.py:293 (_sample_rows, "
                         "XLA-fused: no Pallas kernel)",
             "launches": launches["sample_rows"],
             "launches_by_path": {path: counts.get("sample_rows", 0)
                                  for path, counts in by_path.items()},
             "max_abs_err": main["max_abs_err"], "ms": main["ms"],
             "device_ms": main["device_ms"],
             "device_ms_by": main["device_ms_by"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None,
             "old_tail_ms": main["old_tail_ms"], "shapes": shapes}]


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

    from repro_torch import kernels, roofline
    from repro_torch.kernels.decode_attention import _dense_splits

    dtype, dh, h = torch.bfloat16, 128, 16

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
        # the library's own distance from the plain version: a yardstick of
        # what bf16 rounding (P included) costs
        lib_err = None if library is None else (
            library().float().reshape(ref.shape) - ref.float()
        ).abs().max().item()
        return {"max_abs_err": err, "ms": ms,
                "plain_ms": _median_ms(lambda: plain(*args)),
                "library_ms": None if library is None else _median_ms(library),
                "library_max_abs_err": lib_err}

    rows = []
    # B5: 8 rows at pos 255 of a [8, 1024, 16, 128] cache (transposed view)
    g = torch.Generator().manual_seed(11)
    cache_k, cache_v = (torch.randn(8, 1024, h, dh, generator=g)
                        .to("cuda", dtype).transpose(1, 2) for _ in range(2))
    q1 = torch.randn(8, h, dh, generator=g).to("cuda", dtype)
    pos = torch.tensor(255, dtype=torch.int32, device="cuda")
    mask = (torch.arange(1024, device="cuda") <= 255)[None, None, None]
    b5_args = (q1, cache_k, cache_v, pos)
    m = timed(kernels.decode_attention, kernels.decode_attention,
              kernels.decode_attention_plain, b5_args,
              lambda: F.scaled_dot_product_attention(
                  q1[:, :, None], cache_k, cache_v, attn_mask=mask))
    m.update(_device_only(kernels.decode_attention,
                          lambda: kernels.decode_attention(*b5_args),
                          "dense_decode_split_kernel"))
    seen = 256
    b_ms, b_by = roofline.bound_ms(roofline.dense_decode_work(
        rows=8, heads=h, kv_heads=h, dh=dh, seen=seen, elt=2), dtype)
    splits = _dense_splits("decode_attention", q1, cache_k, cache_v, None)
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention.py:97",
                 "launches": launches["decode_attention"], "splits": splits,
                 **m, "bound_ms": b_ms, "bound_by": b_by})
    log(f"[timing] decode_attention bf16 q(8, 16, 128) cache (8, 16, 1024, "
        f"128) pos 255 S {splits}: kernel {m['ms']:.4f} ms per call (device "
        f"only {_fmt_ms(m['profiled_ms'])} profiled, "
        f"{_fmt_ms(m['queued_ms'])} by queued events), plain "
        f"{m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), max abs err {m['max_abs_err']:.3g}")
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
        b_ms, b_by = roofline.bound_ms(roofline.flash_work(
            batch=8, seq=s_, heads=h, dh=dh, elt=2, pairs=pairs), dtype)
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
                f"({b_by}), max abs err {m['max_abs_err']:.3g} (sdpa's "
                f"{m['library_max_abs_err']})")
    ratio = {name: per_mode["flash_attention_branchy"][name]["ms"]
             / per_mode["flash_attention"][name]["ms"] for name in PAIR_MODES}
    log(f"[timing] B7 / B6 time ratio per mode: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items()))
    b6, b7 = per_mode["flash_attention"], per_mode["flash_attention_branchy"]
    log(f"[timing] B6 causal / SDPA causal "
        f"{b6['causal']['ms'] / b6['causal']['library_ms']:.3f}; kernel / "
        f"plain per mode, B6: "
        + ", ".join(f"{k} {m['ms'] / m['plain_ms']:.4f}" for k, m in b6.items())
        + "; B7: "
        + ", ".join(f"{k} {m['ms'] / m['plain_ms']:.4f}" for k, m in b7.items()))
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



def _time_ssd(b: int, s: int, h: int) -> dict:
    """B8 on ``b`` x ``s`` tokens of ``h`` heads of 64, state 128, chunk
    256, bf16 (the tensor-core body), on the mixer's strided and stride-0
    operands: held against its plain version, then kernel (per call and
    device-only), plain, no library call (no single PyTorch call computes
    SSD), and the bound from this input's bytes and useful flops."""
    from repro_torch import kernels, roofline

    p, n, chunk = 64, 128, 256
    dtype = torch.bfloat16
    args = _ssd_inputs(b, s, h, p, n, dtype, seed=21)
    out = kernels.ssd_chunk(*args, chunk=chunk)
    ref = kernels.ssd_chunk_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    ey, es = _ssd_errs(out, ref)
    rms = _ssd_y_rms(out[0], ref[0])
    err = max((o.float() - r_.float()).abs().max().item()
              for o, r_ in zip(out, ref))
    del out, ref
    check(ey <= SSD_REL_TOL[dtype] and es <= SSD_STATE_REL_TOL
          and rms <= SSD_Y_RMS_TOL,
          f"ssd_chunk x({b}, {s}, {h}, {p}): relative err y {ey:.3g}, state "
          f"{es:.3g}, y rms {rms:.3g}")
    saved = kernels.ssd_chunk.launches  # timing launches are not the path's
    ms = _median_ms(lambda: kernels.ssd_chunk(*args, chunk=chunk))
    kernels.ssd_chunk.launches = saved
    dev = _device_only(kernels.ssd_chunk,
                       lambda: kernels.ssd_chunk(*args, chunk=chunk),
                       "ssd_chunk_tc_kernel")
    plain_ms = _median_ms(lambda: kernels.ssd_chunk_plain(*args, chunk=chunk))
    # each input read once (B and C as their one group), each output
    # written once; flops of the causal half of the two L x L products per
    # chunk, the inter-chunk term and the state update (2 per MAC)
    work = roofline.ssd_chunk_work(batch=b, seq=s, heads=h, head_dim=p,
                                   state=n, chunk=chunk, elt=2)
    nbytes, ops = work.bytes, work.flops
    bound_ms, bound_by = roofline.bound_ms(work, dtype)
    log(f"[timing] ssd_chunk bf16 x({b}, {s}, {h}, {p}) state {n} chunk "
        f"{chunk} (tensor-core body): kernel {ms:.4f} ms per call (device "
        f"only {_fmt_ms(dev['profiled_ms'])} profiled, "
        f"{_fmt_ms(dev['queued_ms'])} by queued events), plain "
        f"{plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms "
        f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
        f"relative err y {ey:.3g} state {es:.3g} y rms {rms:.3g}")
    return {"max_abs_err": err, "max_rel_err": max(ey, es), "ms": ms, **dev,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_ssd_kernel(launches: dict) -> list[dict]:
    """B8 at the mamba2 prefill shape (8 x 1024 tokens, 32 heads)."""
    numbers = _time_ssd(8, 1024, 32)
    return [{"name": "ssd_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_chunk.cu",
             "body": "src/repro_torch/csrc/ssd_chunk_tc.cuh",
             "replaces": "src/repro/kernels/ssd_chunk.py:73",
             "launches": launches["ssd_chunk"], **numbers}]


# ------------------------------------------------------------------ phase 8
def _long_prompt_traffic(cfg, n: int = 2, prompt_len: int = 5000,
                         new_tokens: int = 32) -> list:
    """``n`` greedy requests of ``prompt_len`` distinct prompt tokens and
    ``new_tokens`` each, all arriving at once: gemma2-27b's cell, whose
    positions pass its 4096 window."""
    from repro_torch.runtime.scheduler import Request

    g = torch.Generator().manual_seed(8)
    return [Request(rid=i, new_tokens=new_tokens, greedy=True, arrival_s=0.0,
                    prompt=tuple(torch.randint(0, cfg.vocab_size,
                                               (prompt_len,), generator=g)
                                 .tolist()))
            for i in range(n)]


def _plans() -> dict:
    """Per config: each engine's (EngineConfig fields, slots, traffic,
    engine); full width, weights from a seed. qwen3-14b and hft-demo on
    phase 3's cells (hft-demo's prompts of 200 and bursts of ~200 tokens
    pass its 128 window); gemma2-27b's paged and dense engines on 2 slots
    of 8192 with two 5000-token prompts (its local layers' 4096 window over
    real positions), its burst engine on the burst cell at 8 rows of
    1024."""
    short = dict(max_len=1024, max_batch=8)
    long_ = dict(max_len=8192, max_batch=2)
    burst = dict(short, batch_quantum=4)
    return {
        "qwen3-14b": {
            "paged": (dict(short, page_size=16, prefill_chunk=64), 8,
                      _shared_prefix_traffic, "paged"),
            "continuous": (dict(short, prefill_chunk=64), 8,
                           _continuous_traffic, "continuous"),
            "burst": (burst, None, _burst_traffic, "burst"),
        },
        "gemma2-27b": {
            "paged": (dict(long_, page_size=16, prefill_chunk=64), 2,
                      _long_prompt_traffic, "paged"),
            "burst": (burst, None, _burst_traffic, "burst"),
            "continuous": (dict(long_, prefill_chunk=64), 2,
                           _long_prompt_traffic, "continuous"),
        },
        "hft-demo": {
            "paged": (dict(short, page_size=16, prefill_chunk=64), 8,
                      partial(_continuous_traffic, prompt_len=200), "paged"),
            "continuous": (dict(short, prefill_chunk=64), 8,
                           partial(_continuous_traffic, prompt_len=200),
                           "continuous"),
            "burst": (burst, None, partial(_burst_traffic, tokens_mean=200),
                      "burst"),
        },
    }


def _cell_plans() -> dict:
    """Phase 3's cells by name, each (EngineConfig fields, slots, traffic,
    engine): the paged bf16 cell, dense cell (a), the burst cell and the
    int8+spec paged cell."""
    base = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64)
    return {
        "paged bf16": (base, 8, _shared_prefix_traffic, "paged"),
        "continuous": (dict(max_len=1024, max_batch=8, prefill_chunk=64), 8,
                       _continuous_traffic, "continuous"),
        "burst": (dict(max_len=1024, max_batch=8, batch_quantum=4), None,
                  _burst_traffic, "burst"),
        "paged int8+spec": (dict(base, kv_dtype="int8", spec_k=4,
                                 draft_layers=2, draft_kv_dtype="int8"), 8,
                            _shared_prefix_traffic, "paged"),
    }


def _depth_cut(cfg, layers: int, tag: str):
    """``cfg`` at full width on its first ``layers`` layers."""
    import dataclasses

    full = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=layers).validate()
    log(f"[{tag}:{cfg.name}] depth cut to {cfg.num_layers} of {full} layers, "
        f"full width")
    return cfg


def _depth_view(cfg, params: dict, layers: int, tag: str) -> tuple:
    """``_depth_cut`` with the full model's weights to match: every
    ``blocks.*`` tensor's leading (layer) axis sliced, views of the same
    storage, no copy."""
    cut = _depth_cut(cfg, layers, tag)
    m = layers // cfg.period
    return cut, {k: (t[:m] if k.startswith("blocks.") else t)
                 for k, t in params.items()}


def _seeded(cfg, tag: str) -> dict:
    """Weights seeded on the card, held to ``_weight_bytes``; the init
    peak is the weights and one float32 slab."""
    from repro_torch import models

    _release_engines()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in params.values())
    check(wbytes == _weight_bytes(cfg),
          f"{cfg.name}: {wbytes} weight bytes, reckoned {_weight_bytes(cfg)}")
    pc = cfg.param_counts()
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, {pc['total'] / 1e9:.3f}"
        f"B params ({pc['active'] / 1e9:.3f}B active) {cfg.dtype} "
        f"({wbytes / 1e9:.2f} GB) initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params


def _held_streams(tag: str, cfg, params, plans: dict,
                  slack: float | None = None) -> dict:
    """Each plan's stream (``_paired_streams``: through graph targets with
    the launches held, then eager under one step clock), peak memory
    within the card — or within ``slack`` bytes of the reckoned weights
    and KV — and logged against them; a speculative stream's draft and
    verify lanes ran. Returns {plan name: ``_paired_streams``' output}."""
    outs = {}
    total = torch.cuda.get_device_properties(0).total_memory
    for name, (ecfg, slots, traffic, engine) in plans.items():
        w, kv = _reckoned(cfg, engine, ecfg, slots or 8)
        label = f"{cfg.name} {name}"
        out = outs[name] = _paired_streams(
            label, cfg, params, ecfg, partial(traffic, cfg), engine,
            slots or 8, count=True)
        limit = total if slack is None else w + kv + slack
        check(out["peak"] <= limit,
              f"{label}: peak {out['peak'] / 1e9:.2f} GB over "
              f"{limit / 1e9:.2f} GB")
        log(f"[{tag}:{label}] peak memory {out['peak'] / 1e9:.2f} GB against "
            f"reckoned weights {w / 1e9:.2f} GB + KV {kv / 1e9:.2f} GB = "
            f"{(w + kv) / 1e9:.2f} GB (card {total / 1e9:.2f} GB)")
        if ecfg.get("spec_k"):
            rep = out["report"]
            check(rep["lane_steps"]["draft"] > 0
                  and rep["lane_steps"]["verify"] > 0,
                  f"{label}: draft/verify lane steps {rep['lane_steps']}")
    return outs


def _reckoned(cfg, engine: str, ecfg: dict, slots) -> tuple[float, float]:
    """(weight bytes, KV bytes) from the config before anything is
    allocated: ``_weight_bytes``, and K and V of every attention layer for
    the engine's rows (the page pool with its null page; the dense cache's
    ``dense_rows``; the burst buckets of 4 and 8 rows) at ``2 *
    attention layers * kv_dim`` elements a token — int8 pages at a byte an
    element plus a float32 scale a row, with the int8 draft's dense cache
    — and a mamba layer's conv window and float32 state for each dense
    row."""
    from repro_torch import models

    el = 2 if cfg.dtype == "bfloat16" else 4
    attn = _attention_layers(cfg)
    per_token = 2 * attn * cfg.kv_dim * el
    if engine == "paged":
        tokens = (ecfg["max_batch"] * ecfg["max_len"] + ecfg["page_size"])
    elif engine == "continuous":
        tokens = slots * models.dense_rows(ecfg["max_len"])
    else:
        tokens = (4 + 8) * ecfg["max_len"]
    kv = tokens * per_token
    if ecfg.get("kv_dtype") == "int8":  # a byte an element, 4 a row's scale
        kv = tokens * 2 * attn * (cfg.kv_dim + 4)
        kv += _int8_draft_bytes(cfg, ecfg, slots)
    mamba = cfg.num_layers - attn
    if mamba and engine != "paged":  # a row's conv window and f32 state
        rows = slots if engine == "continuous" else 4 + 8
        conv = (cfg.conv_kernel - 1) * (
            cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * el
        state = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        kv += rows * mamba * (conv + state)
    return _weight_bytes(cfg), kv


def _int8_draft_bytes(cfg, ecfg: dict, slots: int) -> int:
    """The int8 draft's dense cache: K and V of each draft layer for every
    dense row, a byte an element plus a float32 scale a row."""
    from repro_torch import models

    draft = ecfg["draft_layers"] * cfg.period
    return (slots * models.dense_rows(ecfg["max_len"]) * 2 * draft
            * (cfg.kv_dim + 4))


def _attention_layers(cfg) -> int:
    return sum(cfg.mixer_at(i).startswith("attn")
               for i in range(cfg.num_layers))


def _weight_bytes(cfg) -> int:
    """``param_counts`` at the model dtype, but a MoE layer's router and a
    mamba layer's ``A_log``, ``D`` and ``dt_bias`` in float32
    (``param_counts`` counts ``A`` and ``D`` of the three)."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    moe = sum(cfg.mlp_at(i) == "moe" for i in range(cfg.num_layers))
    mamba = cfg.num_layers - _attention_layers(cfg)
    return (cfg.param_counts()["total"] * el
            + moe * cfg.d_model * cfg.num_experts * (4 - el)
            + mamba * cfg.ssm_heads * (3 * 4 - 2 * el))


def _prompt_decode_check(cfg, params, batch: int, prompt_len: int) -> dict:
    """``prefill`` of ``batch`` prompts of ``prompt_len`` (B6, one launch
    per attention layer), its rows copied into pages, then one paged
    decode step at position ``prompt_len`` (B1 per layer) with the kernels
    and with the plain attention on the same cache: logits within
    ``STEP_LOGIT_ATOL`` (bf16) or ``FP32_LOGIT_ATOL``; the same step with
    the window off differs by more, so the window masked real positions.
    Counts set to 0 just before the path, read after the kernel step."""
    import dataclasses

    from repro_torch import kernels, models

    dev, ps = "cuda", 16
    g = torch.Generator().manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                        dtype=torch.int32).to(dev)
    kernels.reset_launch_counts()  # this path's run starts here
    last, dense = models.prefill(cfg, params, tok)
    n = -(-(prompt_len + 1) // ps)
    cache = models.init_paged_cache(cfg, batch * n + 1, ps, device=dev)
    for slot, c in zip(cache, dense, strict=True):
        for name, t in c.items():
            m, _, _, kh, dh = c[name].shape
            c_ = slot[name].view(m, -1, kh, dh)[:, ps:].view(m, batch, n * ps,
                                                             kh, dh)
            c_[:, :, :prompt_len].copy_(t)
    del dense
    bt = torch.arange(1, batch * n + 1, dtype=torch.int32,
                      device=dev).view(batch, n)
    nxt = last.argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    lk, _ = models.paged_decode_step(cfg, params, cache, nxt, pos, bt,
                                     attn_impl="kernel")
    torch.cuda.synchronize()
    layers = cfg.num_layers
    launches = _launches(f"{cfg.name} prompt+decode",
                         ("flash_attention", "paged_decode_attention"))
    for name in ("flash_attention", "paged_decode_attention"):
        check(launches[name] == layers,
              f"{cfg.name} prompt+decode: {name} launched {launches[name]} "
              f"times, expected one per layer ({layers})")
    lp, _ = models.paged_decode_step(cfg, params, cache, nxt, pos, bt,
                                     attn_impl="plain")
    off = dataclasses.replace(cfg, sliding_window=None)
    lw, _ = models.paged_decode_step(off, params, cache, nxt, pos, bt,
                                     attn_impl="plain")
    tol = STEP_LOGIT_ATOL if cfg.dtype == "bfloat16" else FP32_LOGIT_ATOL
    err = (lk - lp).abs().max().item()
    gap = (lw - lp).abs().max().item()
    check(bool(torch.isfinite(lk).all()) and err <= tol,
          f"{cfg.name}: paged decode at {prompt_len}, kernels vs plain "
          f"attention: max abs diff {err:.4f} > {tol}")
    check(gap > err, f"{cfg.name}: the window off changes the step's logits "
          f"by {gap:.4f}, no more than kernel vs plain ({err:.4f})")
    log(f"[configs:{cfg.name}] prefill {batch}x{prompt_len} (B6 x "
        f"{launches['flash_attention']}), one paged decode step at position "
        f"{prompt_len} over a {n}-page table (B1 x "
        f"{launches['paged_decode_attention']}): kernels vs plain attention "
        f"max abs logit diff {err:.4f} (tolerance {tol}); window "
        f"{cfg.sliding_window} off vs on (plain) {gap:.4f}: the window masks "
        f"| launches {launches}")
    return {"launches": launches, "err": err, "window_gap": gap}


def _hft_card_vs_cpu(cfg, params, card_reqs, ecfg: dict, slots: int,
                     traffic) -> None:
    """hft-demo's paged stream (fp32) on the CPU under the step clock
    against the card's graph run of the same requests: greedy tokens
    equal, a divergence only at a near-tie of the CPU logits."""
    from repro_torch.runtime.serve import Engine, EngineConfig, run_paged_stream

    cpu_params = {k: v.cpu() for k, v in params.items()}
    reqs = traffic(cfg)
    with Engine(cfg, cpu_params, EngineConfig(**ecfg), device="cpu") as eng:
        rep = run_paged_stream(eng, reqs, slots=slots, seed=0,
                               clock=_StepClock())
    check(rep["finished"] == len(reqs), "hft-demo CPU stream did not finish")
    card = {r.rid: r.tokens for r in card_reqs}
    ties = compared = 0
    for r in reqs:
        if not r.greedy:
            continue
        compared += 1
        if r.tokens == card[r.rid]:
            continue
        i = next(i for i, (x, y) in enumerate(zip(r.tokens, card[r.rid]))
                 if x != y)
        check(_near_tie(cfg, cpu_params,
                        list(r.effective_prompt) + r.tokens[:i], "fp32"),
              f"hft-demo card != CPU at rid {r.rid} token {i}")
        ties += 1
    log(f"[configs:hft-demo] paged stream card (graphs) = CPU on "
        f"{compared - ties} of {compared} greedy requests, {ties} near-tie "
        f"divergences")


# Phase 8's depth: qwen3-14b, gemma2-27b and hft-demo at full width on 2
# of their layers (gemma2's one local/global pair). Their
# streams' eager runs are host-bound and scale with depth (hft-demo's
# burst twin, ~1200 steps, was 33 s of the script at 4 layers), so this
# keeps the whole script inside its limit with phases 9-16 added.
PHASE8_LAYERS = {"qwen3-14b": 2, "gemma2-27b": 2, "hft-demo": 2}


def configs_phase() -> dict:
    """qwen3-14b and gemma2-27b (bf16; full width, depth cut to
    ``PHASE8_LAYERS``) and hft-demo (fp32, full width, the same) on the
    card, one model at a time, weights seeded on the card: each engine's
    stream (``_paired_streams`` with its launches held), peak memory
    against the reckoned weight and KV bytes; gemma2-27b's and hft-demo's
    prompt + decode check past their windows; hft-demo's stream card =
    CPU."""
    from repro_torch.configs import get_config

    paths = {}
    for arch, plan in _plans().items():
        cfg = get_config(arch)
        if arch in PHASE8_LAYERS:
            cfg = _depth_cut(cfg, PHASE8_LAYERS[arch], "configs")
        params = _seeded(cfg, "configs")
        outs = _held_streams("configs", cfg, params, plan)
        paths.update({f"{arch} {name}": out["launches"]
                      for name, out in outs.items()})
        if arch == "hft-demo":
            ecfg, slots, traffic, _ = plan["paged"]
            _hft_card_vs_cpu(cfg, params, outs["paged"]["requests"], ecfg,
                             slots, traffic)
        if arch == "gemma2-27b":
            paths[f"{arch} prompt+decode"] = _prompt_decode_check(
                cfg, params, 1, 5120)["launches"]
        elif arch == "hft-demo":
            paths[f"{arch} prompt+decode"] = _prompt_decode_check(
                cfg, params, 8, 512)["launches"]
        del params
        _release_engines()
    return paths


# ------------------------------------------------ phase 9 (granite-moe)
GRANITE = "granite-moe-1b-a400m"


def _moe_policies_step(runs: list, slots: int = 8) -> dict:
    """"drop", "dense" and "gather" at S = 1, where capacity is ``top_k``
    and nothing is dropped, for each ``(tag, cfg, params)`` of ``runs``:
    in bf16 one MoE layer (``slots`` rows of full width) within
    ``KERNEL_ATOL[bf16]`` of "dense" relative to its largest |output|; one
    full-width paged decode step (``slots`` slots at position 200 over
    pages a chunked prefill filled under "dense"), held within
    ``STEP_LOGIT_ATOL`` on fp32 weights and logged in bf16 with each
    policy's eager host wall (random bf16 experts turn any two roundings
    into other logits)."""
    from repro_torch import models
    from repro_torch.models import moe

    dev, ps, n = "cuda", 16, 200
    g = torch.Generator().manual_seed(23)
    out = {}
    for tag, c, p in runs:
        name = c.name
        if tag == "bf16":
            slot = next(i for i in range(c.period) if c.mlp_at(i) == "moe")
            lp = models.layer_params(p, slot, 0)["moe"]
            x = torch.randn(slots, 1, c.d_model, generator=g).to(
                dev, torch.bfloat16)
            ys = {pol: moe.moe_apply(c, lp, x, policy=pol, with_aux=False)[0]
                  .float() for pol in ("drop", "dense", "gather")}
            scale = ys["dense"].abs().max().item()
            layer = {pol: (ys[pol] - ys["dense"]).abs().max().item() / scale
                     for pol in ("drop", "gather")}
            del ys
            for pol, rel in layer.items():
                check(rel <= KERNEL_ATOL[torch.bfloat16],
                      f"{name}: one MoE layer at S = 1, {pol} vs dense "
                      f"relative diff {rel:.4g} > "
                      f"{KERNEL_ATOL[torch.bfloat16]}")
            log(f"[moe:{name}] one MoE layer (bf16, {slots} rows, S = 1): "
                f"drop and gather vs dense relative diff {layer} (tolerance "
                f"{KERNEL_ATOL[torch.bfloat16]}): nothing dropped")
        prompt = torch.randint(0, c.vocab_size, (slots, n), generator=g,
                               dtype=torch.int32).to(dev)
        pb = -(-(n + 1) // ps)
        bt = torch.arange(1, slots * pb + 1, dtype=torch.int32,
                          device=dev).view(slots, pb)
        zero = torch.zeros(slots, dtype=torch.int32, device=dev)
        pos = torch.full((slots,), n, dtype=torch.int32, device=dev)
        cache = models.init_paged_cache(c, slots * pb + 1, ps, device=dev)
        last, _ = models.paged_prefill_step(c, p, cache, prompt, zero, bt,
                                            pos, moe_policy="dense")
        tok = last.argmax(-1).to(torch.int32)[:, None]
        logits, ms = {}, {}
        for policy in ("drop", "dense", "gather"):
            def step(policy=policy):
                return models.paged_decode_step(c, p, cache, tok, pos, bt,
                                                moe_policy=policy)[0]
            logits[policy] = step()
            ms[policy] = _wall_ms(step, steps=10)
        torch.cuda.synchronize()
        diff = {f"{a}-dense": (logits[a] - logits["dense"]).abs().max().item()
                for a in ("drop", "gather")}
        agree = {a: (logits[a].argmax(-1) == logits["dense"].argmax(-1))
                 .float().mean().item() for a in ("drop", "gather")}
        if tag == "fp32":
            for pair, err in diff.items():
                check(bool(torch.isfinite(logits[pair[:-6]]).all())
                      and err <= STEP_LOGIT_ATOL,
                      f"{name} fp32: one decode step, {pair} logits "
                      f"differ by {err:.4g} > {STEP_LOGIT_ATOL}")
        out[tag] = {"diff": diff, "agree": agree, "ms": ms}
        log(f"[moe:{name}] one full-width decode step ({tag}, {slots} "
            f"slots, pos {n}) under each moe_policy: logits max abs diff "
            + ", ".join(f"{k} {v:.4g}" for k, v in diff.items())
            + (f" (tolerance {STEP_LOGIT_ATOL})" if tag == "fp32"
               else " (logged, not held)")
            + f", argmax agreement {agree}; eager host wall per step "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f" | {_card()}")
        del cache, logits
    return out


def _granite_moe_share(cfg, params) -> dict:
    """A replayed ``cbp`` step (8 slots at position 200, 16-page tables,
    bf16 pages) through graph targets and eager, profiled as phase 3b's
    (wall, busy, idle share); then the same step with every MoE tail
    replaced by zeros (the attention, norms, embedding, head and sampling
    left), whose busy time subtracted from the full step's is the MoE's
    (the router, the dispatch and combine, the expert products)."""
    from repro_torch.models import moe
    from repro_torch.runtime.serve import Engine, EngineConfig

    ecfg = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64)
    out = {}
    real = moe.moe_apply
    try:
        for variant in ("full", "without MoE"):
            if variant != "full":
                moe.moe_apply = lambda cfg, p, x, **kw: (torch.zeros_like(x),
                                                         None)
            runs, engines = {}, []
            for mode in ("graph", "eager"):
                eng = Engine(cfg, params, EngineConfig(
                    **ecfg, cuda_graphs=mode == "graph"))
                engines.append(eng)
                runs[mode] = _step_runs(eng, "cbp", 8)
            out[variant] = _profile_replay(
                f"{cfg.name} cbp ({variant}; bf16 pages, 8 slots, pos 200, "
                f"16-page tables)", runs)
            for eng in engines:
                eng.close()
            del engines, runs
            _release_engines()
    finally:
        moe.moe_apply = real
    share = {}
    for mode in ("graph", "eager"):
        full, bare = out["full"][mode]["busy_ms"], out["without MoE"][mode][
            "busy_ms"]
        share[mode] = (None if full is None or bare is None
                       else 100 * (full - bare) / full)
    g = out["full"]["graph"]
    idle = g["idle_pct"]
    log(f"[granite] replayed cbp step: wall {g['wall_ms']:.3f} ms, busy "
        f"{_fmt_ms(g['busy_ms'])}, idle "
        f"{'not measured' if idle is None else f'{idle:.1f}%'}"
        f"; the MoE's share of busy "
        + ", ".join(f"{m} {'not measured' if v is None else f'{v:.1f}%'}"
                    for m, v in share.items())
        + f" | {_card()}")
    return {"profile": out, "moe_share_pct": share}


GRANITE_STREAM_LAYERS = 3


def granite_phase() -> dict:
    """granite-moe-1b-a400m at full width (24 layers, bf16, 32 experts top-8,
    heads of 64: every attention call on the bf16 head_dim-64
    instantiations), weights seeded on the card: its four streams (on the
    first ``GRANITE_STREAM_LAYERS`` layers, weights of their own) through
    graph targets and again eager under one step clock (``_paired_streams``
    with each kernel's launches held to one per attention layer per lane
    call), peak memory against the reckoned weight and KV bytes; the
    prompt-then-burst path under "dense"; one decode step under each
    ``moe_policy``; a replayed ``cbp`` step profiled with the MoE's
    share. Across implementations (kernels vs the naive attention, the
    burst's steps vs ``forward``, one policy vs another) granite's bf16
    logits are held in fp32 (the weights upcast on the card): with random
    weights its experts are drawn with ``dense_init``'s fan-in E (std
    1/sqrt(32)), their outputs far larger than their unit-RMS inputs, and a
    bf16 rounding moves a top-k routing choice somewhere in 24 layers,
    which moves the logits by far more than ``STEP_LOGIT_ATOL``; the
    prompt+burst lines log the bf16 and the fp32 gaps side by side."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(GRANITE)
    # the paired streams on a depth cut (their eager twins were ~150 s of
    # the script at 24 layers); everything after them at full depth
    scfg = _depth_cut(cfg, GRANITE_STREAM_LAYERS, "granite")
    params = _seeded(scfg, "granite")
    check(params["blocks.0.moe.router"].dtype == torch.float32,
          f"{GRANITE}: the router is not float32")
    outs = _held_streams("granite", scfg, params, _cell_plans(), slack=1.5e9)
    paths = {f"{GRANITE} {name}": out["launches"]
             for name, out in outs.items()}
    del params
    _release_engines()
    params = _seeded(cfg, "granite")
    paths[f"{GRANITE} prompt+burst"] = prompt_then_burst(
        cfg, params, moe_policy="dense", hold=False)
    # the same path and one decode step on the weights in fp32, held: the
    # tokens to the fp32 tie margin; forward's logits B6 vs naive to
    # STEP_LOGIT_ATOL, since a router near-tie at fp32 rounding can still
    # move one expert choice, and with it the logits that follow
    p32 = {k: v.float() for k, v in params.items()}
    c32 = dataclasses.replace(cfg, dtype="float32")
    paths[f"{GRANITE} fp32 prompt+burst"] = prompt_then_burst(
        c32, p32, moe_policy="dense", logit_tol=STEP_LOGIT_ATOL)
    _moe_policies_step([("fp32", c32, p32), ("bf16", cfg, params)])
    del p32
    share = _granite_moe_share(cfg, params)
    del params
    _release_engines()
    return {"paths": paths, "moe_share": share}


def smoke_card_vs_cpu_of(arch: str, tag: str,
                         engines: tuple = ("paged", "continuous", "burst")
                         ) -> None:
    """``arch``'s smoke config (fp32, TF32 off), a third of the requests
    sampled, on the card (graph targets) and on the CPU under one step
    clock, through each of ``engines``: the paged engine with chunked
    prefill, the dense continuous engine with chunked prefill (an SSM
    slot's prompts token by token), and the burst engine. Greedy requests
    equal or a near-tie of the CPU's drop-free logits; sampled ones
    equal."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import (
        attach_distinct_prompts,
        poisson_arrivals,
        shared_prefix_arrivals,
    )
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_burst_stream,
        run_continuous_stream,
        run_paged_stream,
    )

    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=0)
    plans = {
        "paged": dict(max_len=64, max_batch=4, page_size=8, num_pages=40,
                      prefill_chunk=16),
        "continuous": dict(max_len=64, max_batch=4, prefill_chunk=16),
        "burst": dict(max_len=64, max_batch=8, batch_quantum=4),
    }
    for engine in engines:
        ecfg = plans[engine]
        streams = {}
        for dev in ("cuda", "cpu"):
            if engine == "paged":
                reqs = shared_prefix_arrivals(
                    12, 1000.0, seed=2, num_prefixes=3, prefix_len=20,
                    tokens_mean=8, total_max=64, sample_frac=1 / 3,
                    vocab=cfg.vocab_size)
            else:
                reqs = poisson_arrivals(12, 1000.0, seed=2, tokens_mean=8,
                                        tokens_max=40, sample_frac=1 / 3,
                                        vocab=cfg.vocab_size)
                if engine == "continuous":
                    attach_distinct_prompts(reqs, 20, vocab=cfg.vocab_size,
                                            seed=3)
            with Engine(cfg, params, EngineConfig(**ecfg), device=dev) as eng:
                if engine == "burst":
                    rep = run_burst_stream(eng, reqs, clock=_StepClock())
                elif engine == "continuous":
                    rep = run_continuous_stream(eng, reqs, slots=4,
                                                clock=_StepClock())
                else:
                    rep = run_paged_stream(eng, reqs, slots=4,
                                           clock=_StepClock())
                check(eng.graphs == (dev == "cuda"),
                      f"{tag} smoke {dev}: cuda_graphs {eng.graphs}")
            check(rep["finished"] == len(reqs),
                  f"{tag} smoke {engine} {dev}: {rep['finished']} finished")
            if engine != "burst":
                check(rep["compiles_after_warmup"] == 0,
                      f"{tag} smoke {engine} {dev}: "
                      f"{rep['compiles_after_warmup']} compiles after warmup")
            streams[dev] = {r.rid: (r.effective_prompt, r.tokens, r.greedy)
                            for r in reqs}
        ties = 0
        for rid, (prompt, toks, greedy) in streams["cpu"].items():
            card = streams["cuda"][rid][1]
            if card == toks:
                continue
            i = next(i for i, (x, y) in enumerate(zip(toks, card)) if x != y)
            check(greedy and _near_tie(cfg, params, list(prompt) + toks[:i],
                                       "fp32"),
                  f"{tag} smoke {engine}: card != CPU at rid {rid} token {i}")
            ties += 1
        n = sum(len(t) for _, t, _ in streams["cpu"].values())
        sampled = sum(not g for _, _, g in streams["cpu"].values())
        log(f"[{tag}:smoke] {engine}: card (graphs) = CPU on "
            f"{len(streams['cpu']) - ties} of {len(streams['cpu'])} requests "
            f"({sampled} sampled, {n} tokens), {ties} near-tie divergences")


# ------------------------------------------ phase 10 (the last five archs)
DEEPSEEK, GROK, JAMBA = ("deepseek-67b", "grok-1-314b",
                         "jamba-1.5-large-398b")
EMBEDS = ("internvl2-1b", "musicgen-medium")
# Phase 10's depth cuts, full width: deepseek-67b on 2 of its 95 layers
# (its eager runs are host-bound and scale with depth), grok-1-314b on 2
# of its 64 (a layer's 8 experts of d_ff 32768 are 9.7 GB, read whole by
# every step under "drop": its streams are bound by those reads, and its
# int8+spec cell's draft is cut to 1 layer, shorter than the target),
# and jamba as one of each of its layer kinds (one period of its 8
# layers is 45.1 B params, 90.3 GB in bf16, more than one card holds).
PHASE10_LAYERS = {DEEPSEEK: 2, GROK: 2}
GROK_DRAFT_LAYERS = 1


def _jamba_cut(cfg):
    """jamba-1.5-large-398b's two-layer cut: a mamba2 mixer (256 SSD heads
    of 64, state 128) with its 16-expert top-2 MoE of d_ff 24576, then an
    attention layer (64 heads over 8 of 128) with a dense MLP of 24576 —
    one of each of its layer kinds at the published widths (11.9 B params,
    23.8 GB bf16); built here only, never as a config."""
    import dataclasses

    return dataclasses.replace(
        cfg, name=f"{cfg.name}-cut2", num_layers=2,
        layer_pattern=("mamba", "attn"), mlp_pattern=("moe", "mlp"),
    ).validate()


def _served(tag: str, cfg, params, cells: tuple,
            draft_layers: int | None = None) -> dict:
    """``_held_streams`` on the named cells of ``_cell_plans`` (a
    speculative cell's draft on ``draft_layers`` where given); returns
    {path: launches}."""
    plans = {c: _cell_plans()[c] for c in cells}
    for c, (ecfg, slots, traffic, engine) in plans.items():
        if draft_layers is not None and ecfg.get("spec_k"):
            plans[c] = (dict(ecfg, draft_layers=draft_layers), slots,
                        traffic, engine)
    outs = _held_streams(tag, cfg, params, plans)
    return {f"{cfg.name} {c}": out["launches"] for c, out in outs.items()}


def deepseek_phase() -> dict:
    """deepseek-67b (bf16, 64 heads over 8 of 128: a GQA group of 8, B2's Q
    by TMA) on ``PHASE10_LAYERS`` of its 95 layers: phase 3's paged bf16
    cell, dense cell (a) and the burst cell, and the prompt-then-burst path
    (prefill 8 x 256, 32 burst tokens, forward), held as olmo-1b's."""
    from repro_torch.configs import get_config

    cfg = _depth_cut(get_config(DEEPSEEK), PHASE10_LAYERS[DEEPSEEK],
                     "families")
    params = _seeded(cfg, "deepseek")
    paths = _served("deepseek", cfg, params,
                    ("paged bf16", "continuous", "burst"))
    paths[f"{cfg.name} prompt+burst"] = prompt_then_burst(cfg, params)
    del params
    _release_engines()
    return paths


def grok_phase() -> dict:
    """grok-1-314b (bf16, 48 heads over 8 of 128: a GQA group of 6 — B2/B4
    take the 16-byte Q path, B1/B3/B5 end each kv head in a partial tile of
    2 rows — softcaps 30/30, 8 experts top-2 of d_ff 32768) on
    ``PHASE10_LAYERS`` of its 64 layers, under "drop": the paged bf16
    cell, phase 3's int8+spec paged cell (B3/B4 at group 6 with softcap
    30; its draft on ``GROK_DRAFT_LAYERS``) and the burst cell, graph =
    eager and launches held; the prompt+burst path at 2 x 512 and one
    decode step per policy at 2 rows, logged in bf16 (random experts route
    chaotically) and held on fp32 weights of its first layer (~26 GB; the
    bf16 weights are released as they are widened)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = _depth_cut(get_config(GROK), PHASE10_LAYERS[GROK], "families")
    params = _seeded(cfg, "grok")
    paths = _served("grok", cfg, params,
                    ("paged bf16", "paged int8+spec", "burst"),
                    draft_layers=GROK_DRAFT_LAYERS)
    pb = dict(b=2, prompt_len=512, moe_policy="dense")
    paths[f"{cfg.name} prompt+burst"] = prompt_then_burst(
        cfg, params, hold=False, **pb)
    _moe_policies_step([("bf16", cfg, params)], slots=2)
    _release_engines()
    c32 = dataclasses.replace(cfg, dtype="float32", num_layers=1).validate()
    p32 = {}
    for k in list(params):
        t = params.pop(k)
        p32[k] = (t[:1] if k.startswith("blocks.") else t).float()
        del t
    del params
    _release_engines()
    log(f"[grok] fp32 weights of layer 0 "
        f"({sum(t.numel() * 4 for t in p32.values()) / 1e9:.2f} GB)")
    paths[f"{cfg.name} fp32 prompt+burst"] = prompt_then_burst(
        c32, p32, logit_tol=STEP_LOGIT_ATOL, **pb)
    _moe_policies_step([("fp32", c32, p32)], slots=2)
    del p32
    _release_engines()
    return paths


def jamba_phase() -> dict:
    """jamba-1.5-large-398b: (a) its smoke config card (graphs) = CPU
    through the dense continuous engine (``cb``; prompts token by token, as
    for any SSM slot) and the burst engine; (b) its two-layer full-width
    cut (``_jamba_cut``): ``prefill`` over 2 x 1024 (B8 at 256 heads, B6 at
    group 8), 32 burst tokens (B5), ``forward``, then a dense continuous
    stream (``cb``, B1 over the page view) and the burst cell, graph =
    eager and launches held; kernels vs the plain path (B6 vs the naive
    attention, B8 vs ``ssd_scan``, the burst vs ``forward``) held on fp32
    weights, logged in bf16 (random experts route chaotically)."""
    import dataclasses

    from repro_torch.configs import get_config

    smoke_card_vs_cpu_of(JAMBA, "jamba", engines=("continuous", "burst"))
    cfg = _jamba_cut(get_config(JAMBA))
    params = _seeded(cfg, "jamba")
    pb = dict(b=2, prompt_len=1024, moe_policy="dense", max_len=1088)
    paths = {f"{cfg.name} prompt+burst": prompt_then_burst(
        cfg, params, hold=False, **pb)}
    paths.update(_served("jamba", cfg, params, ("continuous", "burst")))
    _release_engines()
    for k in list(params):  # widened in place: the bf16 copy goes as it does
        params[k] = params[k].float()
    _release_engines()
    c32 = dataclasses.replace(cfg, dtype="float32")
    log(f"[jamba] fp32 weights of the cut "
        f"({sum(t.numel() * 4 for t in params.values()) / 1e9:.2f} GB)")
    paths[f"{cfg.name} fp32 prompt+burst"] = prompt_then_burst(
        c32, params, logit_tol=STEP_LOGIT_ATOL, **pb)
    del params
    _release_engines()
    return paths


def embeddings_prompt_then_step(arch: str) -> dict:
    """An embeddings-input arch at full width and depth (bf16, seeded
    weights, no token embedding table): seeded ``[8, 256, D]`` embeddings
    through ``prefill`` (B6), ``pad_cache`` to 1024, ``set_mode`` and a
    one-step ``decode_loop`` fed ``[8, D]`` embeddings (B5, through the
    graph target's ``[8, 1, D]`` bf16 input), then ``forward`` over the 257
    positions (B6), with the counts set to 0 just before and read after.
    Held: the launches, ``prefill``'s last logits against ``forward``'s at
    position 255 and the step's tokens against ``forward``'s position 256
    (``STEP_LOGIT_ATOL``), ``forward`` B6 against the naive attention, and
    the step through an eager target (graph = eager)."""
    from repro_torch import kernels, models
    from repro_torch.configs import get_config
    from repro_torch.core.graph_target import WARMUP_RUNS
    from repro_torch.models.layers import dtype_of
    from repro_torch.runtime import steps
    from repro_torch.runtime.serve import GREEDY, Engine, EngineConfig

    cfg = get_config(arch)
    params = _seeded(cfg, "embeddings")
    check("embed.embedding" not in params, f"{arch}: an embedding table")
    b, prompt_len, max_len = 8, 256, 1024
    g = torch.Generator().manual_seed(11)
    emb = torch.randn(b, prompt_len + 1, cfg.d_model, generator=g).to(
        "cuda", dtype_of(cfg))
    prompt, nxt = emb[:, :prompt_len], emb[:, prompt_len]
    ecfg = dict(max_len=max_len, max_batch=b, batch_quantum=4)
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    last, cache = steps.make_prefill_fn(cfg)(params, prompt)
    cache = models.pad_cache(cfg, cache, max_len)
    with Engine(cfg, params, EngineConfig(**ecfg)) as eng:
        check(eng.graphs, f"{arch}: the burst target is not a CUDA graph")
        eng.set_mode(batch=b, sampling=GREEDY)
        toks, _ = eng.decode_loop(_into_burst_cache(eng, b, cache), nxt,
                                  prompt_len, 1)
        replays = eng._current.graph.replays
        static = eng._current.static_inputs[0]
        check(tuple(static.shape) == (b, 1, cfg.d_model)
              and static.dtype == dtype_of(cfg),
              f"{arch}: the graph's input is {tuple(static.shape)} "
              f"{static.dtype}")
    logits, _ = models.forward(cfg, params, emb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(f"{arch} prompt+step",
                         ("flash_attention", "decode_attention"))
    want = {"flash_attention": 2 * layers,
            "decode_attention": layers * (WARMUP_RUNS + replays)}
    for name, n in want.items():
        check(launches[name] == n, f"{arch} prompt+step: {name} launched "
              f"{launches[name]} times, expected {n}")
    check(toks.shape == (b, 1) and bool(torch.isfinite(logits).all())
          and logits.shape == (b, prompt_len + 1, cfg.vocab_size),
          f"{arch}: tokens {toks.shape}, logits {tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated()
    w, kv = _reckoned(cfg, "burst", ecfg, None)
    pre = (last.float() - logits[:, prompt_len - 1].float()).abs().max().item()
    gen = logits[:, prompt_len].float()
    chosen = torch.from_numpy(toks[:, 0]).to("cuda").long()
    lead = (gen.max(-1).values - gen.gather(-1, chosen[:, None])[:, 0]).max()
    naive, _ = models.forward(cfg, params, emb, impl="naive")
    err = (logits - naive).abs().max().item()
    del naive
    with Engine(cfg, params, EngineConfig(**ecfg, cuda_graphs=False)) as eng:
        eng.set_mode(batch=b, sampling=GREEDY)
        eager, _ = eng.decode_loop(cache, nxt[:, None], prompt_len, 1)
    check(pre <= STEP_LOGIT_ATOL and float(lead) < STEP_LOGIT_ATOL
          and err <= STEP_LOGIT_ATOL,
          f"{arch}: prefill vs forward {pre:.4f}, forward's lead over the "
          f"step's token {float(lead):.4f}, B6 vs naive {err:.4f} (tolerance "
          f"{STEP_LOGIT_ATOL})")
    check((toks == eager).all(), f"{arch}: graph and eager one-step tokens "
          f"differ on {int((toks != eager).sum())} rows")
    log(f"[embeddings] {arch}: prefill {b}x{prompt_len}x{cfg.d_model} "
        f"embeddings (B6), pad_cache to {max_len}, one decode step on [{b}, "
        f"1, {cfg.d_model}] {cfg.dtype} embeddings through the graph target "
        f"(B5), forward over {prompt_len + 1} positions (B6) in {wall:.2f}s "
        f"| prefill's last logits vs forward's max abs {pre:.4f}, forward's "
        f"top logit leads the step's token by {float(lead):.4f}, forward B6 "
        f"vs naive {err:.4f} (tolerance {STEP_LOGIT_ATOL}); graph = eager on "
        f"{b} rows | launches {launches} | peak {peak / 1e9:.2f} GB against "
        f"reckoned weights {w / 1e9:.3f} GB + burst caches {kv / 1e9:.3f} GB"
        f" | {_card()}")
    del params, cache, logits
    _release_engines()
    return launches


def embeddings_smoke_card_vs_cpu(arch: str) -> None:
    """The smoke config's one-step path (fp32, TF32 off): ``[4, 12, 64]``
    embeddings through ``prefill``, ``pad_cache`` and a one-step
    ``decode_loop``, greedy and sampled, on the card (graph target) and on
    the CPU: tokens equal (a greedy one may flip only at a near-tie of the
    CPU's logits)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import (
        GREEDY,
        SAMPLE,
        Engine,
        EngineConfig,
    )

    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=0)
    g = torch.Generator().manual_seed(12)
    emb = torch.randn(4, 13, cfg.d_model, generator=g)
    key = torch.tensor([0, 7], dtype=torch.int32)
    ecfg = EngineConfig(max_len=32, max_batch=4, batch_quantum=4)
    for mode in (GREEDY, SAMPLE):
        toks = {}
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev) for k, v in params.items()}
            e = emb.to(dev)
            _, cache = models.prefill(cfg, p, e[:, :12])
            cache = models.pad_cache(cfg, cache, 32)
            with Engine(cfg, p, ecfg, device=dev) as eng:
                check(eng.graphs == (dev == "cuda"),
                      f"{arch} smoke {dev}: cuda_graphs {eng.graphs}")
                eng.set_mode(batch=4, sampling=mode)
                if eng.graphs:
                    cache = _into_burst_cache(eng, 4, cache)
                toks[dev], _ = eng.decode_loop(cache, e[:, 12], 12, 1,
                                               rng=key)
        same = toks["cuda"] == toks["cpu"]
        if not same.all():
            check(mode == GREEDY, f"{arch} smoke: sampled tokens differ")
            logits, _ = models.forward(cfg, params, emb)
            top2 = logits[:, -1].topk(2).values
            gap = (top2[:, 0] - top2[:, 1])[torch.from_numpy(~same[:, 0])]
            check(bool((gap < TIE_MARGIN).all()),
                  f"{arch} smoke: card != CPU, top-2 gaps {gap.tolist()}")
        tag = "greedy" if mode == GREEDY else "sampled"
        log(f"[embeddings:smoke] {arch} {tag}: one-step tokens card (graph) "
            f"= CPU on {int(same.sum())} of 4 rows")


def families_phase() -> dict:
    """Phase 10: deepseek-67b, grok-1-314b, jamba-1.5-large-398b,
    internvl2-1b and musicgen-medium. Returns {path: launches}."""
    paths = deepseek_phase()
    paths.update(grok_phase())
    paths.update(jamba_phase())
    for arch in EMBEDS:
        paths[f"{arch} prompt+step"] = embeddings_prompt_then_step(arch)
        embeddings_smoke_card_vs_cpu(arch)
    return paths


def _time_case(label: str, fn, call, plain, library, work, dtype,
               kernel: str, yardstick=None) -> dict:
    """One kernel call at a new shape: held against its plain version, then
    kernel ms per call, device-only, plain, library (None: no PyTorch call
    computes this function) and the bound; ``yardstick``, where given, is
    SDPA on the same inputs without the softcap, which SDPA cannot apply.
    Timing launches are not a path's launches."""
    out, ref = call(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= KERNEL_ATOL[dtype], f"{label}: max abs err {err:.3g}")
    saved = fn.launches
    ms = _median_ms(call)
    fn.launches = saved
    dev = _device_only(fn, call, kernel)
    plain_ms = _median_ms(plain)
    library_ms = yard_ms = None
    try:
        if library is not None:
            library_ms = _median_ms(library)
        if yardstick is not None:
            yard_ms = _median_ms(yardstick)
    except RuntimeError as e:  # a yardstick only: the port never calls it
        log(f"[timing:new] {label}: sdpa not timed ({e})")
    from repro_torch import roofline

    bound_ms, by = roofline.bound_ms(work, dtype)
    log(f"[timing:new] {label}: kernel {ms:.4f} ms per call (device only "
        f"{_fmt_ms(dev['profiled_ms'])} profiled, "
        f"{_fmt_ms(dev['queued_ms'])} by queued events), plain "
        f"{plain_ms:.4f} ms, sdpa "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}"
        + ("" if yardstick is None else
           f" (sdpa without the softcap {_fmt_ms(yard_ms)})")
        + f", bound {bound_ms:.4f} ms ({by}), max abs err {err:.3g}")
    extra = {} if yardstick is None else {"sdpa_no_softcap_ms": yard_ms}
    return {"max_abs_err": err, "ms": ms, **dev, "plain_ms": plain_ms,
            "library_ms": library_ms, **extra, "bound_ms": bound_ms,
            "bound_by": by}


def time_new_shapes() -> dict:
    """B1, B2, B5 and B6 at the shapes phases 8-10 give them — group 5
    (qwen3-14b: 40 heads over 8 of 128, bf16), window 4096 at positions
    past it (gemma2-27b: 32 over 16 of 128, bf16; the softcap left out so
    that SDPA computes the same function), fp32 head_dim 64 (hft-demo: 4
    over 4 of 64, window 128), bf16 head_dim 64 (granite-moe: 16 over 8 of
    64, group 2; B3 and B4 too, over int8 pages), group 6 with softcap 30
    (grok-1-314b: 48 over 8 of 128; B4 too; SDPA cannot apply a softcap,
    so it is timed without one beside the kernel, as a yardstick) and
    group 8 (deepseek-67b and jamba: 64 over 8 of 128; B4 too), olmo-1b's
    shard on a mesh of model size 2 (8 over 8 of 128: phases 14-15's B1
    and B2 launches, and phase 15's B3 and B4, B4 also over the ``vf``
    lane's 8 x 5 window), and B5 and
    B6 alone at group 7 (internvl2-1b: 14 over 2 of 64) and MHA 24
    (musicgen-medium: 24 over 24 of 64) — against their plain versions and
    SDPA, with the bound from the bytes and pairs this data needs; and B8
    at jamba's 256 SSD heads (2 x 1024 tokens). Returns {kernel: {shape:
    numbers}}."""
    import torch.nn.functional as F

    from repro_torch import kernels, roofline

    dev, ps = "cuda", 16
    out: dict = {}

    def paged(kv_tokens, pairs, kv_row, q):
        return roofline.paged_attention_work(
            dh=q.shape[-1], pairs=pairs, kv_tokens=kv_tokens,
            kv_row_bytes=kv_row,
            io_bytes=2 * q.numel() * q.element_size() + 4 * rows * (table + 1))

    def add(name, shape, numbers):
        out.setdefault(name, {})[shape] = numbers

    bf16 = torch.bfloat16
    pos8 = [96, 120, 150, 180, 200, 220, 240, 255]
    starts8 = [0, 64, 128, 192, 0, 64, 128, 192]
    b1256 = {"B1", "B2", "B5", "B6"}
    # h, kh, dh, dtype, window, rows, table, positions, chunk starts,
    # dense cache length and position, B6's tokens, softcap, kernels
    for shape, (h, kh, dh, dtype, window, rows, table, pos, starts, cache_len,
                dense_pos, seq, softcap, which) in {
        "group 5": (40, 8, 128, bf16, None, 8, 16, pos8, starts8, 1024, 255,
                    1024, None, b1256),
        "window 4096": (32, 16, 128, bf16, 4096, 2, 512, [5000, 8191],
                        [5000, 8128], 8192, 5000, 5120, None, b1256),
        "fp32 dh 64": (4, 4, 64, torch.float32, 128, 8, 16, pos8, starts8,
                       1024, 255, 1024, None, b1256),
        "granite bf16 dh 64": (16, 8, 64, bf16, None, 8, 16, pos8, starts8,
                               1024, 255, 1024, None, b1256 | {"B3", "B4"}),
        "grok group 6 softcap 30": (48, 8, 128, bf16, None, 8, 16, pos8,
                                    starts8, 1024, 255, 1024, 30.0,
                                    b1256 | {"B3", "B4"}),
        "deepseek group 8": (64, 8, 128, bf16, None, 8, 16, pos8, starts8,
                             1024, 255, 1024, None, b1256 | {"B4"}),
        "olmo shard at mp 2": (8, 8, 128, bf16, None, 8, 16, pos8, starts8,
                               1024, 255, 1024, None,
                               b1256 | {"B3", "B4", "B4 verify"}),
        "internvl2 group 7 dh 64": (14, 2, 64, bf16, None, 8, 16, pos8,
                                    starts8, 1024, 255, 1024, None,
                                    {"B5", "B6"}),
        "musicgen MHA 24 dh 64": (24, 24, 64, bf16, None, 8, 16, pos8,
                                  starts8, 1024, 255, 1024, None,
                                  {"B5", "B6"}),
    }.items():
        g = torch.Generator().manual_seed(31)
        el = torch.tensor([], dtype=dtype).element_size()
        kw = dict(window=window, softcap=softcap)

        def lib(fn):  # (library, yardstick): SDPA applies no softcap
            return (None, fn) if softcap is not None else (fn, None)
        n_pages = rows * table + 1
        kp, vp = (torch.randn(n_pages, ps, kh, dh, generator=g).to(dev, dtype)
                  for _ in range(2))
        bt = (torch.randperm(n_pages - 1, generator=g) + 1).view(rows, table)
        bt = bt.to(torch.int32).to(dev)
        gk, gv = (p_[bt.long()].reshape(rows, table * ps, kh, dh)
                  .transpose(1, 2).contiguous() for p_ in (kp, vp))
        ki = torch.arange(table * ps, device=dev)

        def visible(qpos):  # [..., L] keys each query sees
            ok = ki <= qpos[..., None]
            if window is not None:
                ok &= ki > qpos[..., None] - window
            return ok

        # B1: one query a row
        pt = torch.tensor(pos, dtype=torch.int32, device=dev)
        q1 = torch.randn(rows, h, dh, generator=g).to(dev, dtype)
        ok = visible(pt.long())
        keys = int(ok.sum())
        if "B1" in which:
            sdpa = lib(lambda: F.scaled_dot_product_attention(
                q1[:, :, None], gk, gv, attn_mask=ok[:, None, None],
                enable_gqa=True))
            add("paged_decode_attention", shape, _time_case(
                f"paged_decode_attention {shape} q{tuple(q1.shape)} table "
                f"{tuple(bt.shape)}", kernels.paged_decode_attention,
                lambda: kernels.paged_decode_attention(q1, kp, vp, bt, pt,
                                                       **kw),
                lambda: kernels.paged_decode_attention_plain(
                    q1.float(), kp.float(), vp.float(), bt, pt, **kw),
                sdpa[0], paged(keys, keys * h, kh * dh * el, q1), dtype,
                "paged_decode_split",
                yardstick=sdpa[1]))
        # B2: a chunk of 64 a row
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        qc = torch.randn(rows, 64, h, dh, generator=g).to(dev, dtype)
        qi = st[:, None].long() + torch.arange(64, device=dev)[None]
        okc = visible(qi)
        keys_c = int(okc.any(1).sum())
        if "B2" in which:
            sdpa = lib(lambda: F.scaled_dot_product_attention(
                qc.transpose(1, 2), gk, gv, attn_mask=okc[:, None],
                enable_gqa=True))
            add("paged_prefill_attention", shape, _time_case(
                f"paged_prefill_attention {shape} q{tuple(qc.shape)} table "
                f"{tuple(bt.shape)}", kernels.paged_prefill_attention,
                lambda: kernels.paged_prefill_attention(qc, kp, vp, bt, st,
                                                        **kw),
                lambda: kernels.paged_prefill_attention_plain(
                    qc.float(), kp.float(), vp.float(), bt, st, **kw),
                sdpa[0], paged(keys_c, int(okc.sum()) * h, kh * dh * el, qc),
                dtype, "paged_prefill",
                yardstick=sdpa[1]))
        if which & {"B3", "B4"}:
            # B3/B4: the same rows over the pool quantised to int8; the
            # library call on the dequantised rows, gathered before timing
            (kq, ks), (vq, vs) = _quantised(kp.float()), _quantised(vp.float())
            gk8, gv8 = ((p_[bt.long()].float() * s_[bt.long()][..., None, None])
                        .reshape(rows, table * ps, kh, dh).transpose(1, 2)
                        .to(dtype).contiguous()
                        for p_, s_ in ((kq, ks), (vq, vs)))
        if "B3" in which:
            sdpa = lib(lambda: F.scaled_dot_product_attention(
                q1[:, :, None], gk8, gv8, attn_mask=ok[:, None, None],
                enable_gqa=True))
            add("paged_decode_attention_int8", shape, _time_case(
                f"paged_decode_attention_int8 {shape} q{tuple(q1.shape)} "
                f"table {tuple(bt.shape)}",
                kernels.paged_decode_attention_int8,
                lambda: kernels.paged_decode_attention_int8(
                    q1, kq, vq, ks, vs, bt, pt, **kw),
                lambda: kernels.paged_decode_attention_int8_plain(
                    q1.float(), kq, vq, ks, vs, bt, pt, **kw),
                sdpa[0], paged(keys, keys * h, kh * dh + 4, q1), dtype,
                "paged_decode_split",
                yardstick=sdpa[1]))
        if "B4" in which:
            sdpa = lib(lambda: F.scaled_dot_product_attention(
                qc.transpose(1, 2), gk8, gv8, attn_mask=okc[:, None],
                enable_gqa=True))
            add("paged_prefill_attention_int8", shape, _time_case(
                f"paged_prefill_attention_int8 {shape} q{tuple(qc.shape)} "
                f"table {tuple(bt.shape)}",
                kernels.paged_prefill_attention_int8,
                lambda: kernels.paged_prefill_attention_int8(
                    qc, kq, vq, ks, vs, bt, st, **kw),
                lambda: kernels.paged_prefill_attention_int8_plain(
                    qc.float(), kq, vq, ks, vs, bt, st, **kw),
                sdpa[0], paged(keys_c, int(okc.sum()) * h, kh * dh + 4, qc),
                dtype, "paged_prefill",
                yardstick=sdpa[1]))
        if "B4 verify" in which:  # the vf lane's window: 5 rows a slot
            qv = qc[:, :5].contiguous()
            sv = pt - 4  # windows that end at the decode positions
            okv = visible(sv[:, None].long()
                          + torch.arange(5, device=dev)[None])
            keys_v = int(okv.any(1).sum())
            sdpa = lib(lambda: F.scaled_dot_product_attention(
                qv.transpose(1, 2), gk8, gv8, attn_mask=okv[:, None],
                enable_gqa=True))
            add("paged_prefill_attention_int8", f"{shape}, verify 8 x 5",
                _time_case(
                    f"paged_prefill_attention_int8 {shape} verify "
                    f"q{tuple(qv.shape)} table {tuple(bt.shape)}",
                    kernels.paged_prefill_attention_int8,
                    lambda: kernels.paged_prefill_attention_int8(
                        qv, kq, vq, ks, vs, bt, sv, **kw),
                    lambda: kernels.paged_prefill_attention_int8_plain(
                        qv.float(), kq, vq, ks, vs, bt, sv, **kw),
                    sdpa[0], paged(keys_v, int(okv.sum()) * h, kh * dh + 4,
                                   qv),
                    dtype, "paged_prefill", yardstick=sdpa[1]))
        if which & {"B3", "B4"}:
            del kq, vq, gk8, gv8
        del kp, vp, gk, gv
        # B5: every row at one position of a [rows, cache_len, KH, dh] cache
        ck, cv = (torch.randn(rows, cache_len, kh, dh, generator=g)
                  .to(dev, dtype).transpose(1, 2) for _ in range(2))
        p0 = torch.tensor(dense_pos, dtype=torch.int32, device=dev)
        kd = torch.arange(cache_len, device=dev)
        okd = kd <= dense_pos
        if window is not None:
            okd &= kd > dense_pos - window
        seen = int(okd.sum())
        sdpa = lib(lambda: F.scaled_dot_product_attention(
            q1[:, :, None], ck, cv, attn_mask=okd[None, None, None],
            enable_gqa=True))
        add("decode_attention", shape, _time_case(
            f"decode_attention {shape} q{tuple(q1.shape)} cache "
            f"{tuple(ck.shape)} pos {dense_pos}", kernels.decode_attention,
            lambda: kernels.decode_attention(q1, ck, cv, p0, **kw),
            lambda: kernels.decode_attention_plain(
                q1.float(), ck.float(), cv.float(), p0, **kw),
            sdpa[0], roofline.dense_decode_work(
                rows=rows, heads=h, kv_heads=kh, dh=dh, seen=seen, elt=el),
            dtype, "dense_decode_split",
            yardstick=sdpa[1]))
        del ck, cv
        # B6: causal (and the window) over seq tokens
        b6 = 1 if seq > 1024 else 2
        q, k, v = (torch.randn(b6, seq, n, dh, generator=g).to(dev, dtype)
                   .transpose(1, 2) for n in (h, kh, kh))
        qs = torch.arange(seq, device=dev)
        okf = qs[None] <= qs[:, None]
        if window is not None:
            okf &= qs[None] > qs[:, None] - window
        pairs = b6 * h * int(okf.sum())
        sdpa = lib(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=okf, enable_gqa=True))
        add("flash_attention", shape, _time_case(
            f"flash_attention {shape} q{tuple(q.shape)} causal window "
            f"{window} softcap {softcap}", kernels.flash_attention,
            lambda: kernels.flash_attention(q, k, v, causal=True, **kw),
            lambda: kernels.flash_attention_plain(
                q.float(), k.float(), v.float(), causal=True, **kw),
            sdpa[0], roofline.flash_work(batch=b6, seq=seq, heads=h, dh=dh,
                                         elt=el, pairs=pairs, kv_heads=kh),
            dtype, "flash_", yardstick=sdpa[1]))
        del q, k, v
        torch.cuda.empty_cache()
    add("ssd_chunk", "jamba 256 heads", _time_ssd(2, 1024, 256))
    return out


# ----------------------------------- phase 11 (the overload-hardened stream)
# olmo-1b at full width (bf16): 8 slots, max_len 1024, page 16, chunked
# prefill 64, the int8 pool warmed beside the bf16 one (the ladder's
# standby), spec_k 4 with a 2-layer int8 draft; every target a CUDA graph.
OVERLOAD_ECFG = dict(max_len=1024, max_batch=8, page_size=16,
                     prefill_chunk=64, kv_dtypes=("int8",), spec_k=4,
                     draft_layers=2, draft_kv_dtype="int8")
# The flood's plan, armed before the engine warms: (site, ordinal, extras).
# The flood runs under a _BatcherClock (4 ms a batcher step, both
# batchers' steps counted): its arrivals span ~48 ms, a dozen steps, and
# its queue TTL is 50 ms, so the heartbeat outage (beats 2-4 suppressed,
# detected at iteration 4 when the monitor times out) forces the bottom
# rung while requests queue, whatever the host's pace, and the int8
# standby takes admissions; the stall lands near iteration 10, after both
# batchers' watchdogs are past their 5-step warmup. The stall (a real 50
# ms sleep) and the watchdog still act on the wall clock.
FLOOD_FAULTS = (("build", 0, {}), ("step_output", 3, {}),
                ("step_output", 9, {}),
                ("d2h_stall", 60, {"stall_s": 0.05}),
                ("pool_alloc", 5, {}), ("pool_alloc", 40, {}),
                ("heartbeat", 1, {"span": 3}))
OVERLOAD_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                    "paged_decode_attention_int8",
                    "paged_prefill_attention_int8", "sample_rows")


def _flood_traffic(cfg) -> list:
    """96 shared-prefix requests (4 prefixes of 128, lengths mean 16, max
    64, a quarter sampled), Poisson at 2000 req/s, every fourth with a
    deadline 0.5 s after its arrival."""
    from repro_torch.runtime.scheduler import shared_prefix_arrivals

    reqs = shared_prefix_arrivals(
        96, 2000.0, seed=0, num_prefixes=4, prefix_len=128, tokens_mean=16,
        tokens_max=64, total_max=1024, sample_frac=0.25,
        vocab=cfg.vocab_size)
    for r in reqs[::4]:
        r.deadline_s = r.arrival_s + 0.5
    return reqs


def _overload_inert(cfg, params, ecfg: dict = OVERLOAD_ECFG,
                    modes: tuple = (False, True), tag: str = "") -> dict:
    """Part 1: phase 3's bf16-cell traffic through ``run_paged_stream`` and
    through ``run_overload_stream`` with every knob at its default, on one
    engine (``ecfg``) under a ``_BatcherClock``, sync then async (``modes``):
    every token equal, no shed, cancel, failure or unserved request, no
    ladder move, 0 captures after warmup, and each run's B1-B4 and
    ``sample_rows`` counts (set to 0 just before it) equal between the two
    loops (sync). ``tag`` names the arm in the log (phase 16: "1x2")."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_overload_stream,
        run_paged_stream,
    )

    runs = {}
    _release_engines()
    with Engine(cfg, params, EngineConfig(**ecfg)) as eng:
        check(eng.graphs, "overload: the engine's targets are not CUDA graphs")
        # capture every target once before the compared runs: a capture's
        # eager runs launch the kernels too, and only the first run on an
        # engine would pay them
        eng.paged_continuous(slots=8, seed=0)
        for async_steps in modes:
            for loop, run in (("paged", run_paged_stream),
                                ("overload", run_overload_stream)):
                label = f"overload{tag and ' ' + tag} inert {loop}/async={async_steps}"
                reqs = _shared_prefix_traffic(cfg)
                kernels.reset_launch_counts()  # this path's run starts here
                rep = _BatcherClock().run(eng, run, reqs, slots=8, seed=0,
                                          async_steps=async_steps)
                torch.cuda.synchronize()
                launches = _launches(label, OVERLOAD_KERNELS)
                _check_stream(label, cfg, reqs, rep)
                check(rep["compiles_after_warmup"] == 0,
                      f"{label}: {rep['compiles_after_warmup']} captures "
                      f"after warmup")
                if loop == "overload":
                    for k in ("shed", "cancelled", "failed", "unserved"):
                        check(rep[k] == 0, f"{label}: {k} {rep[k]}")
                    check(rep["degrade_transitions"] == [],
                          f"{label}: ladder moved {rep['degrade_transitions']}")
                runs[loop, async_steps] = ([r.tokens for r in reqs], rep,
                                             launches)
    base = runs["paged", False]
    for key, (toks, rep, launches) in runs.items():
        check(toks == base[0], f"overload inert {key}: tokens differ from "
              f"the synchronous run_paged_stream's")
    check(runs["overload", False][2] == base[2],
          f"overload inert: launches {runs['overload', False][2]} != "
          f"run_paged_stream's {base[2]}")
    rep = runs["overload", False][1]
    ahead = (f" | async run-ahead steps "
             f"{runs['overload', True][1]['steps'] - rep['steps']}"
             if True in modes else "")
    log(f"[overload{tag and ':' + tag}:inert] bf16 cell's {rep['finished']} "
        f"requests ({rep['tokens']} tokens) through run_overload_stream = "
        f"run_paged_stream, {'sync and async' if True in modes else 'sync'}"
        f", every token (sampled too); "
        f"{rep['steps']} steps, lane calls {rep['lane_calls']}, 0 shed / "
        f"cancelled / failed / unserved, no ladder move, 0 captures after "
        f"warmup | launches (sync) {base[2]}{ahead}")
    return {"launches": base[2]}


def _flood_checks(label: str, rep: dict, reqs: list, plan,
                  standby_prompts: int) -> None:
    """The flood's accounting: every request finished, shed, cancelled or
    failed, once; every fault detected and contained or failed; no poison
    in a stream; the ladder moved down and the int8 standby took
    admissions (its ``pf`` targets ingested ``standby_prompts`` chunks)."""
    check(rep["finished"] + rep["shed"] + rep["cancelled"] + rep["failed"]
          == len(reqs) and rep["unserved"] == 0,
          f"{label}: finished {rep['finished']} shed {rep['shed']} cancelled "
          f"{rep['cancelled']} failed {rep['failed']} unserved "
          f"{rep['unserved']} of {len(reqs)}")
    fates = [(r.t_done is not None) + bool(r.shed_reason and not r.cancelled)
             + r.cancelled + (r.error is not None) for r in reqs]
    check(fates == [1] * len(reqs), f"{label}: a request's fate is not one "
          f"of finished / shed / cancelled / failed: {fates}")
    fr = plan.report()
    for site, n in fr["injected"].items():
        # a heartbeat outage of span 3 suppresses three beats (three
        # injected opportunities) and is detected once, when the monitor
        # times out, and contained once, when beats resume
        want = (sum(1 for s, _, _ in FLOOD_FAULTS if s == site)
                if site == "heartbeat" else n)
        det = fr["detected"].get(site, 0)
        con = fr["contained"].get(site, 0)
        lost = sum(1 for r in reqs if r.error == site)
        check(det == want and con + lost == want,
              f"{label}: {site} injected {n}, detected {det}, contained "
              f"{con}, failed {lost}")
    check(set(fr["injected"]) == {s for s, _, _ in FLOOD_FAULTS},
          f"{label}: sites injected {fr['injected']}")
    for r in reqs:
        check(all(t >= 0 for t in r.tokens), f"{label} rid {r.rid}: a "
              f"negative token in a stream")
        if r.t_done is not None:
            check(len(r.tokens) == r.new_tokens, f"{label} rid {r.rid}: short")
    check(any(t["from"] != t["to"] and t["why"] in ("overload", "heartbeat")
              for t in rep["degrade_transitions"]),
          f"{label}: no downward ladder transition")
    check(standby_prompts > 0, f"{label}: the int8 standby ingested "
          f"{standby_prompts} prompt chunks: it admitted nothing")
    check(rep["compiles_after_warmup"] == 0,
          f"{label}: {rep['compiles_after_warmup']} captures after warmup")


def _flood_fates(reqs: list, rep: dict, observed: list) -> dict:
    """What the flood did to each request, its shed counts by reason and
    its ladder transitions, and the controller's calls as (step-clock time,
    straggler, transitions made before the call): the straggler is the
    watchdog's one real-time input, and under the step clock two arms that
    saw the same stragglers run one schedule."""
    return {
        "fates": [(r.rid, r.t_done is not None, r.shed_reason, r.cancelled,
                   r.error) for r in reqs],
        "shed": rep.get("robustness", {}).get("shed"),
        "transitions": rep["degrade_transitions"],
        "stragglers": [t for t, s, _ in observed if s],
        "observed": observed,
    }


def _flood_arms_equal(plain: dict, traced: dict) -> str:
    """The flood's two arms against each other. Seeing the same
    stragglers, they give every request the same fate, the same shed
    counts by reason and the same ladder transitions. The watchdog acts on
    the wall clock and a straggler moves the ladder (its ``over`` signal),
    so where the arms saw different stragglers only the transitions made
    before the controller's call at the first such difference must agree
    (the call itself may move the ladder in one arm and not in the other);
    the rest is logged."""
    if plain["stragglers"] == traced["stragglers"]:
        for key in ("fates", "shed", "transitions"):
            check(plain[key] == traced[key], f"overload flood: the plain and "
                  f"the traced arm differ in {key}: {plain[key]} != "
                  f"{traced[key]}")
        return (f"{len(plain['fates'])} fates, shed {plain['shed']}, "
                f"{len(plain['transitions'])} ladder transitions equal "
                f"(stragglers at {plain['stragglers']} in both)")
    first = min(set(plain["stragglers"]) ^ set(traced["stragglers"]))
    made = [next((n for t, _, n in arm["observed"] if t >= first),
                 len(arm["transitions"])) for arm in (plain, traced)]
    before = [arm["transitions"][:n] for arm, n in zip((plain, traced), made)]
    check(before[0] == before[1], f"overload flood: the arms' ladder "
          f"transitions differ before their stragglers do (the call at t "
          f"{first}): {before[0]} != {before[1]}")
    return (f"stragglers at {plain['stragglers']} / {traced['stragglers']} "
            f"(the watchdog's wall clock): {len(before[0])} transitions "
            f"before the call at t {first} equal; fates equal "
            f"{plain['fates'] == traced['fates']}, shed equal "
            f"{plain['shed'] == traced['shed']}, transitions "
            f"{[(t['t'], t['to']) for t in plain['transitions']]} / "
            f"{[(t['t'], t['to']) for t in traced['transitions']]}")


def _overload_flood(cfg, params, telemetry: bool,
                    ecfg: dict = OVERLOAD_ECFG, tag: str = "") -> dict:
    """Parts 2 and 3: the flood through ``run_overload_stream`` on a fresh
    engine (``ecfg``; the plan armed before it warms, so the ``build``
    fault hits a capture) under a ``_BatcherClock`` (arrivals, the queue
    TTL and the deadlines counted in steps), watchdog on; with
    ``telemetry`` the flight recorder is on and the trace and metrics are
    exported and checked. ``tag`` names the arm in the log."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.core.faults import Fault, FaultPlan
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.runtime.degrade import DegradeController
    from repro_torch.runtime.serve import Engine, EngineConfig, run_overload_stream
    from repro_torch.runtime.tracing import (
        lane_track,
        parse_prometheus,
        validate_trace,
        write_trace,
    )

    label = ("overload" + (tag and " " + tag) + " flood"
             + (" traced" if telemetry else ""))
    plan = FaultPlan([Fault(site=s, at=a, **kw) for s, a, kw in FLOOD_FAULTS])
    tel = Telemetry(enabled=telemetry)
    reqs = _flood_traffic(cfg)
    _release_engines()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()  # this path's run starts here
    t0 = time.perf_counter()
    with Engine(cfg, params, EngineConfig(**ecfg), telemetry=tel) as eng:
        observed: list = []
        observe = DegradeController.observe

        def noted(ctrl, now, **kw):  # reads the controller's inputs only
            observed.append((round(now, 6), bool(kw.get("straggler")),
                             len(ctrl.transitions)))
            return observe(ctrl, now, **kw)

        DegradeController.observe = noted
        try:
            rep = _BatcherClock().run(
                eng, run_overload_stream, reqs, slots=8, seed=0,
                capacity=16, shed_policy="drop-oldest", queue_ttl_s=0.05,
                degrade=True, faults=plan)
        finally:
            DegradeController.observe = observe
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want, _ = _lane_launches(eng)
        # the standby's own calls: every int8-pool key's replays past its
        # two warm runs (both batchers' warm passes replay every key)
        replays = {
            k: eng._decode.cache.get(k).graph.replays - 2
            for k in eng._decode.cache.keys()
            if k[0] in ("cbp", "pf", "vf") and k[3] == "int8"}
        standby = sum(replays.values())
        standby_prompts = sum(n for k, n in replays.items() if k[0] == "pf")
    launches = _launches(label, tuple(want))
    for name, n in want.items():
        check(launches[name] == n, f"{label}: {name} launched "
              f"{launches[name]} times, the targets' replays make {n}")
    check(standby > 0, f"{label}: the int8 standby's targets replayed "
          f"{standby} times past warmup (finished {rep['finished']}, shed "
          f"{rep['shed']}, steps {rep['steps']}, transitions "
          f"{rep['degrade_transitions'][:4]}, faults {rep['faults']})")
    _flood_checks(label, rep, reqs, plan, standby_prompts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    w, kv16 = _reckoned(cfg, "paged", OVERLOAD_ECFG, 8)
    _, kv8 = _reckoned(cfg, "paged", dict(OVERLOAD_ECFG, kv_dtype="int8"), 8)
    # each batcher's draft state parked while the other's is resident
    parked = 2 * _int8_draft_bytes(cfg, OVERLOAD_ECFG, 8)
    reckoned = (w + kv16 + kv8 + parked) / 1e9
    rob = rep.get("robustness", {})
    out = {"launches": launches, "standby_calls": standby, "wall": wall,
           **_flood_fates(reqs, rep, observed)}
    if telemetry:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            trace = write_trace(str(path), tel.recorder)
            problems = validate_trace(json.loads(path.read_text()))
        check(problems == [], f"{label}: trace problems {problems[:5]}")
        tracks = {e["args"]["name"] for e in trace["traceEvents"]
                  if e["name"] == "thread_name"}
        lanes = {lane_track(lane) for lane, n in rep["lane_calls"].items()
                 if n}
        need = lanes | {"dispatcher", "scheduler", "page-pool"}
        check(need <= tracks, f"{label}: tracks {sorted(tracks)} lack "
              f"{sorted(need - tracks)}")
        prom = parse_prometheus(tel.registry.to_prometheus())
        snap = json.loads(tel.metrics_json())
        check("counters" in snap and prom["samples"] > 0,
              f"{label}: metrics {prom}")
        # the registry's counters and the robustness block against what
        # the requests' fates and the plan count; the build fault fires
        # inside warmup, which the warm boundary's rollover moves out of
        # the live counters (its label stays, at 0)
        fr = plan.report()
        want = {
            "shed": Counter(r.shed_reason for r in reqs
                            if r.shed_reason and not r.cancelled),
            "cancelled": Counter(r.shed_reason for r in reqs if r.cancelled),
            "failed": Counter(r.error for r in reqs if r.error),
            **{f"faults_{k}": {s: n for s, n in fr[k].items()
                               if s != "build"}
               for k in ("injected", "detected", "contained")},
        }
        for key, family, lab in (
                ("shed", "admission_shed_total", "reason"),
                ("cancelled", "requests_cancelled_total", "reason"),
                ("failed", "requests_failed_total", "site"),
                ("faults_injected", "faults_injected_total", "site"),
                ("faults_detected", "faults_detected_total", "site"),
                ("faults_contained", "faults_contained_total", "site")):
            vals = {k: int(v) for k, v in
                    tel.registry.labeled_values(family, lab).items()
                    if k != "build"}
            rob_vals = {k: v for k, v in rob.get(key, {}).items()
                        if k != "build"}
            check(vals == dict(want[key]) == rob_vals, f"{label}: registry "
                  f"{family} {vals}, robustness {rob.get(key)}, counted "
                  f"{dict(want[key])}")
        out["trace_events"] = len(trace["traceEvents"])
        log(f"[overload:telemetry] trace {len(trace['traceEvents'])} events "
            f"({tel.recorder.dropped} dropped) on tracks {sorted(tracks)}, "
            f"validate_trace [] | prometheus {prom['samples']} samples of "
            f"{len(prom['types'])} families | registry = robustness block = "
            f"the requests' fates and the plan")
    log(f"[overload{tag and ':' + tag}:flood{' traced' if telemetry else ''}]"
        f" olmo-1b bf16{tag and ' at ' + tag}, "
        f"{len(reqs)} requests at 2000 req/s into 8 slots: finished "
        f"{rep['finished']}, shed {rep['shed']} {rob.get('shed')}, cancelled "
        f"{rep['cancelled']} {rob.get('cancelled')}, failed {rep['failed']}, "
        f"unserved {rep['unserved']} | on the step clock: "
        f"{rep.get('tok_per_s', 0.0):.1f} tok/s, latency p50 {rep.get('p50_ms', 0.0):.1f} ms p95 "
        f"{rep.get('p95_ms', 0.0):.1f} ms, ttft p50 "
        f"{rep.get('ttft_p50_ms', 0.0):.1f} ms p95 "
        f"{rep.get('ttft_p95_ms', 0.0):.1f} ms | steps {rep['steps']}, "
        f"stragglers {rep['stragglers']}, deadline missed "
        f"{rep['deadline_missed']}, preemptions {rep['preemptions']} | rung "
        f"dwell s {rob.get('rung_dwell_s')}, transitions "
        f"{[(t['t'], t['to'], t['why']) for t in rep['degrade_transitions']]}"
        f" | standby: {standby_prompts} int8 prompt chunks, {standby} int8 "
        f"replays | faults {plan.report()} | 0 captures after warmup | peak "
        f"{peak:.2f} GB, reckoned {reckoned:.2f} GB (weights + bf16 and "
        f"int8 pools + int8 draft and its two parked copies) | {wall:.1f}s incl. warmup | {_card()}")
    return out


def _overload_launcher() -> None:
    """Part 4: the launcher's overload flags as a user runs them, a
    subprocess on the card (smoke config): exit 0, a report with every
    request accounted and 0 captures after warmup, a trace that validates
    and a ``.prom`` file that parses."""
    import os
    import tempfile

    from repro_torch.runtime.tracing import parse_prometheus, validate_trace

    with tempfile.TemporaryDirectory() as tmp:
        trace, prom = Path(tmp) / "t.json", Path(tmp) / "m.prom"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
               "--engine", "overload", "--degrade", "--chaos-seed", "7",
               "--trace-out", str(trace), "--metrics-out", str(prom),
               "--json"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             env=env, timeout=300)
        check(out.returncode == 0, f"launcher overload: exit "
              f"{out.returncode}: {out.stderr[-2000:]}")
        text = out.stdout
        rep = json.loads(text[text.index("{\n"):])
        check(rep["engine"] == "overload" and rep["unserved"] == 0
              and rep["finished"] + rep["shed"] + rep["cancelled"]
              + rep["failed"] == 24,
              f"launcher overload: accounting {rep}")
        check(rep["compiles_after_warmup"] == 0,
              f"launcher overload: {rep['compiles_after_warmup']} captures")
        problems = validate_trace(json.loads(trace.read_text()))
        check(problems == [], f"launcher overload: trace {problems[:5]}")
        prom_ = parse_prometheus(prom.read_text())
    log(f"[overload:launcher] python -m repro_torch.launch.serve --smoke "
        f"--engine overload --degrade --chaos-seed 7 --trace-out "
        f"--metrics-out --json on the card: exit 0, {rep['finished']} "
        f"finished, {rep['steps']} steps, faults {rep['faults']['injected']}, "
        f"trace valid, {prom_['samples']} prometheus samples")


def overload_phase(cfg, params) -> dict:
    """Phase 11: the overload-hardened paged stream at full width (olmo-1b
    bf16): inert = ``run_paged_stream``; the flood with its faults; the
    flood again with the flight recorder on; the launcher's flags. Returns
    the launch counts of the inert run and the flood (``paths``)."""
    t0 = time.perf_counter()
    inert = _overload_inert(cfg, params)
    flood = _overload_flood(cfg, params, telemetry=False)
    traced = _overload_flood(cfg, params, telemetry=True)
    log(f"[overload:flood] plain arm against traced arm under the step "
        f"clock: {_flood_arms_equal(flood, traced)}")
    _overload_launcher()
    _release_engines()
    seconds = time.perf_counter() - t0
    log(f"[overload] phase 11 passed in {seconds:.1f}s | {_card()}")
    return {"paths": {"overload inert": inert["launches"],
                      "overload flood": flood["launches"]},
            "seconds": seconds}


# ------------------------------------------------------------------ phase 12
def _bf16_cell_tokens(eng, cfg, build_second_at: int | None = None,
                      second=None):
    """Phase 3's bf16 cell's stream through ``run_paged_stream``'s loop
    under a step clock (so every run admits alike), on a new batcher of
    ``eng`` (or ``second``, an already built one); with
    ``build_second_at`` another batcher of the same key is built just
    before that step of this one. Returns (tokens by rid, the batcher
    built)."""
    from repro_torch.runtime.scheduler import RequestQueue

    reqs = _shared_prefix_traffic(cfg)
    cb = second or eng.paged_continuous(slots=8, seed=0)
    clock, q, built = _StepClock(), RequestQueue(reqs), None
    while q or cb.has_work:
        now = clock.now()
        due = q.pop_due(now, limit=cb.free_slots)
        for r in (cb.admit(due, now=now) if due else []):
            q.submit(r)
        if cb.has_work:
            if built is None and cb.stats.steps == build_second_at:
                built = eng.paged_continuous(slots=8, seed=0)
            cb.step(now=clock.now())
            for r in cb.preempted:
                q.submit(r)
            cb.preempted.clear()
            continue
        nxt = q.next_arrival()
        if nxt is None:
            break
        clock.jump_to(nxt)
    check(all(len(r.tokens) == r.new_tokens for r in reqs),
          "c13: a request did not finish")
    return {r.rid: r.tokens for r in reqs}, built


def c13_on_card(cfg, params) -> tuple[float, dict]:
    """Two batchers of one key on one engine keep their own pools (ROADMAP
    C13): the second, built at the first's third step, neither changes the
    first's tokens nor captures anything, and then serves the same stream
    to the same tokens from its own pool. The kernels' counts are set to 0
    just before the two-batcher run and read just after, each held to the
    graph targets' replays in that run. Returns (seconds, the counts)."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import Engine, EngineConfig

    label = "c13 two batchers"
    _release_engines()
    t0 = time.perf_counter()
    ecfg = EngineConfig(max_len=1024, max_batch=8, page_size=16,
                        prefill_chunk=64)
    with Engine(cfg, params, ecfg) as eng:
        want, _ = _bf16_cell_tokens(eng, cfg)
        captures = eng._decode.stats.misses
        before, _ = _lane_launches(eng)
        kernels.reset_launch_counts()  # this path's run starts here
        got, second = _bf16_cell_tokens(eng, cfg, build_second_at=3)
        check(second is not None, "c13: the second batcher was not built")
        check(got == want, "c13: a second batcher built at step 3 changed "
              "the first batcher's tokens")
        again, _ = _bf16_cell_tokens(eng, cfg, second=second)
        torch.cuda.synchronize()
        after, _ = _lane_launches(eng)
        launches = _launches(label, tuple(after))
        for name, n in after.items():
            ran = n - before.get(name, 0)
            check(launches[name] == ran,
                  f"{label}: {name} launched {launches[name]} times, the "
                  f"targets' replays in this run reckon {ran}")
        check(again == want, "c13: the second batcher's stream differs")
        extra = eng._decode.stats.misses - captures
        check(extra == 0, f"c13: {extra} captures after the first run")
    seconds = time.perf_counter() - t0
    ran = ", ".join(f"{k} {launches[k]}" for k in sorted(after))
    log(f"[train:c13] bf16 cell, a second batcher of its key built at step "
        f"3: the first's {sum(map(len, got.values()))} tokens equal its run "
        f"alone, the second then serves the stream to the same tokens, 0 "
        f"captures after the first run; launches in the two-batcher run "
        f"({ran}) equal the targets' replays ({seconds:.1f}s)")
    return seconds, launches


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 8, 512, 12, 2
# a bf16 parameter's ulp at the weights' scale (std 0.02) is ~1e-4, so a
# smaller step would round away
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)


def _device_batch(cfg, batch: int, seq: int, step: int = 0,
                  device: str = "cuda") -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(cfg, DataConfig(batch, seq, seed=0))
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(step).items()}


def _fresh_state(cfg, device: str = "cuda", params: dict | None = None):
    from repro_torch import models
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import TrainState

    if params is None:
        params = models.init_params(cfg, seed=0, device=device)
    return TrainState(params=params, opt=adamw.init(params))


def _reckoned_train_bytes(cfg, batch: int, seq: int) -> dict:
    """Params and grads at the model dtype, float32 mu and nu, and the
    activations: under remat "block" each layer's input is kept ([B, S, D]
    at the model dtype), one layer is recomputed at a time (its naive
    attention's float32 scores, mask add, exp and probabilities, [B, H, S,
    S] each, and its MLP's three [B, S, F] products), and the head's
    float32 logits, their log-softmax's exp and the logits' gradient
    ([B, S, V] float32 each, and the product at the model dtype)."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    n = _weight_bytes(cfg) // el
    tok = batch * seq
    acts = (cfg.num_layers * tok * cfg.d_model * el
            + 4 * batch * cfg.num_heads * seq * seq * 4
            + 3 * tok * cfg.d_ff * el
            + tok * cfg.vocab_size * (3 * 4 + el))
    return {"params": n * el, "grads": n * el, "moments": 2 * n * 4,
            "activations": acts}


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


# cuBLAS's and CUTLASS's matrix-product kernels on Hopper (cuBLASLt names
# its own nvjet_*)
_GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass", "sm90_")


def _train_step_split(cfg, state, batch, opt_cfg) -> str:
    """One more step taken apart, as ``make_train_fn`` runs it: the loss
    and its gradient, then the in-place AdamW update, each timed by CUDA
    events; the same step under ``torch.profiler``: device busy, the
    matrix products' share (kernels named nvjet/gemm/xmma/cutlass/sm90),
    the float32 elementwise and reduction passes' and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    from repro_torch.optim import adamw

    def step() -> tuple[float, float]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        leaves = {k: p.detach().requires_grad_()
                  for k, p in state.params.items()}
        loss, _ = models.loss_fn(cfg, leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[1].record()
        adamw.update(opt_cfg, dict(zip(leaves, grads)), state.opt,
                     state.params)
        ev[2].record()
        ev[2].synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    fb, up = step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = _kernel_ms(prof, 1)
    busy = sum(by_name.values())
    if busy == 0:
        return (f"loss + grad {fb:.1f} ms, AdamW {up:.1f} ms; device busy "
                f"not measured (the profiler recorded no kernels)")
    products = {k: v for k, v in by_name.items()
                if any(n in k.lower() for n in _GEMM_NAMES)}
    gemm = sum(products.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"loss + grad {fb:.1f} ms, AdamW {up:.1f} ms (CUDA events); "
            f"profiled step busy {busy:.1f} ms, matrix products {gemm:.1f} "
            f"ms ({100 * gemm / busy:.1f}%, {len(products)} kernels), the "
            f"rest {busy - gemm:.1f} ms; top: "
            + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top))


def train_full_width() -> dict:
    """olmo-1b at full width: 12 steps on one repeated batch."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_fn

    cfg = get_config("olmo-1b")
    _release_engines()
    torch.cuda.reset_peak_memory_stats()
    state = _fresh_state(cfg)
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    fn = make_train_fn(cfg, adamw.AdamWConfig(**TRAIN_OPT))
    kernels.reset_launch_counts()  # the training path's run starts here
    losses, norms, ms = [], [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = fn(state, batch)
        end.record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        end.synchronize()
        ms.append(start.elapsed_time(end))
    launches = _launches("train olmo-1b", ())
    loss = [float(x) for x in losses]
    gnorm = [float(x) for x in norms]
    check(all(map(_finite, losses + norms)),
          f"train olmo-1b: a loss or grad norm is not finite: {loss} {gnorm}")
    check(loss[-1] < loss[0], f"train olmo-1b: the loss did not fall on its "
          f"repeated batch: step 1 {loss[0]:.4f}, step 12 {loss[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated()
    reck = _reckoned_train_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ)
    step_ms = statistics.median(ms[TRAIN_WARM:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train:olmo-1b] full width, bf16, remat {cfg.remat!r}, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps on one "
        f"batch: loss {loss[0]:.4f} -> {loss[-1]:.4f}, grad norm "
        f"{gnorm[0]:.3f} -> {gnorm[-1]:.3f} | step ms (CUDA events) median "
        f"{step_ms:.3f} of steps {TRAIN_WARM + 1}-{TRAIN_STEPS} (all: "
        f"{', '.join(f'{x:.1f}' for x in ms)}) | {tokens / step_ms * 1e3:.1f} "
        f"tokens/s | peak {peak / 1e9:.2f} GB, reckoned "
        f"{sum(reck.values()) / 1e9:.2f} GB ("
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in reck.items())
        + f") | kernel launches {launches} | {_card()}")
    split = _train_step_split(cfg, state, batch,
                              adamw.AdamWConfig(**TRAIN_OPT))
    log(f"[train:olmo-1b] a 13th step taken apart: {split}")
    del state
    return {"launches": launches, "step_ms": step_ms}


def _train_leaves(state) -> dict:
    """Every tensor of a ``TrainState``: params, mu, nu and the step."""
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{k}": v for k, v in state.opt.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt.nu.items()})
    out["step"] = state.opt.step
    return out


def _train_gap(state, want: dict) -> tuple[float, str]:
    """The largest |difference| of ``state`` from the snapshot ``want``,
    and the leaf where it is."""
    have = _train_leaves(state)
    gaps = {k: float((have[k].float() - v.float()).abs().max())
            for k, v in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_resume_cut() -> None:
    """A two-layer cut at olmo-1b's widths (bf16): 6 steps + save + restore
    + 6 against 12 uninterrupted. The step is deterministic on one card, so
    the restore must give back params, mu, nu and step bit for bit, and the
    resumed run the uninterrupted run's losses and state exactly."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_fn

    cfg = _depth_cut(get_config("olmo-1b"), 2, "train:resume")
    _release_engines()
    fn = make_train_fn(cfg, adamw.AdamWConfig(**TRAIN_OPT))
    batches = [_device_batch(cfg, 4, 256, step=i) for i in range(12)]
    state = _fresh_state(cfg)
    whole = []
    for b in batches:
        state, m = fn(state, b)
        whole.append(float(m["loss"]))
    # the step updates in place, so snapshots are clones
    want = {k: v.clone() for k, v in _train_leaves(state).items()}
    del state
    tmp = Path(tempfile.mkdtemp(prefix="repro-torch-ckpt-"))
    try:
        state = _fresh_state(cfg)
        for b in batches[:6]:
            state, _ = fn(state, b)
        saved = {k: v.clone() for k, v in _train_leaves(state).items()}
        mgr = CheckpointManager(tmp, async_write=False)
        t0 = time.perf_counter()
        mgr.save(6, state)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
        del state
        t0 = time.perf_counter()
        step, state = mgr.restore(_fresh_state(cfg))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        check(step == 6, f"train resume: restored step {step}")
        back, where = _train_gap(state, saved)
        check(back == 0, f"train resume: the restored state differs from the "
              f"saved one by {back} at {where}")
        del saved
        resumed = []
        for b in batches[6:]:
            state, m = fn(state, b)
            resumed.append(float(m["loss"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff, where = _train_gap(state, want)
    check(diff == 0 and resumed == whole[6:],
          f"train resume: 6 + restore + 6 steps differ from 12 by {diff} at "
          f"{where}, losses {resumed} vs {whole[6:]}")
    log(f"[train:resume] 2-layer cut, bf16, 4 x 256: the restore gives back "
        f"params, mu, nu and step bit for bit, and 6 steps + save + restore "
        f"+ 6 = 12 uninterrupted bit for bit (params, mu, nu, step and every "
        f"loss; step 12 loss {resumed[-1]:.4f}) | checkpoint "
        f"{nbytes / 1e9:.3f} GB written in {t_save:.2f}s "
        f"({nbytes / 1e9 / t_save:.2f} GB/s), restored in "
        f"{t_restore:.2f}s; the directory removed")


def train_smoke_card_vs_cpu() -> None:
    """3 fp32 steps of the smoke configs, card = CPU (TF32 off, phase 1)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_fn

    for arch in ("olmo-1b", "mamba2-370m"):
        cfg = get_config(arch).smoke()
        fn = make_train_fn(cfg, adamw.AdamWConfig(**TRAIN_OPT))
        params = models.init_params(cfg, seed=0)
        runs = {}
        for dev in ("cpu", "cuda"):
            state = _fresh_state(cfg, params={k: v.to(dev).clone()
                                              for k, v in params.items()})
            losses = []
            for i in range(3):
                state, m = fn(state, _device_batch(cfg, 4, 32, i, dev))
                losses.append(float(m["loss"]))
            runs[dev] = (losses, {k: v.cpu() for k, v in state.params.items()})
        (cl, cp), (gl, gp) = runs["cpu"], runs["cuda"]
        diff = max(float((gp[k] - cp[k]).abs().max()) for k in cp)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        check(rel <= 1e-5 and diff <= 1e-4,
              f"train {arch} smoke: card {gl} vs CPU {cl}, params {diff}")
        log(f"[train:smoke] {arch}: 3 fp32 steps card = CPU, losses "
            f"{', '.join(f'{x:.6f}' for x in gl)}, max relative loss "
            f"difference {rel:.3g} (limit 1e-5), params max |diff| {diff:.3g} "
            f"(limit 1e-4)")


def train_launcher() -> None:
    """The launcher as a user runs it, on the card: 10 steps, then resume
    to 20."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                "--batch", "4", "--seq", "64", "--ckpt-dir", tmp,
                "--ckpt-every", "5", "--log-every", "5"]
        outs = []
        for extra in (["--steps", "10"], ["--steps", "20", "--resume"]):
            out = subprocess.run(base + extra, capture_output=True, text=True,
                                 cwd=ROOT, env=env, timeout=300)
            check(out.returncode == 0, f"launcher train {extra}: exit "
                  f"{out.returncode}: {out.stderr[-2000:]}")
            outs.append(out.stdout)
    check("[train] resumed from step 10" in outs[1]
          and "[train] done at step 20" in outs[1],
          f"launcher train: {outs[1][-1000:]}")
    last = [ln for ln in outs[1].splitlines() if " loss " in ln][-1]
    log(f"[train:launcher] python -m repro_torch.launch.train --smoke on the "
        f"card: 10 steps, then --resume to 20 ({last.strip()})")


def train_phase() -> dict:
    """Phase 12's training part (the C13 check runs after phase 11)."""
    t0 = time.perf_counter()
    full = train_full_width()
    train_resume_cut()
    train_smoke_card_vs_cpu()
    train_launcher()
    _release_engines()
    return dict(full, seconds=time.perf_counter() - t0)


# -------------------- phase 17 (training on a mesh of logical devices)
# olmo-1b at full width and depth (bf16, remat "block"), phase 12's batch of
# 8 x 512: the sharded train step (FSDP over "data", TP over "model") at
# 1x1, 1x2 and 2x2 on logical devices of this card, held to the one-device
# make_train_fn and, leaf by leaf after one step, to 1x1; the fp32 smoke
# config at 2x2 held to the CPU at 1x1; the elastic re-mesh on a 2-layer
# fp32 cut.
TRAIN_MESHES = ((1, 1), (1, 2), (2, 2))
MESH_TRAIN_STEPS = 3
# bf16: the same function with its sums in other orders (the TP shards'
# partial products, the vocab-parallel logsumexp); the first loss and the
# first step's grad_norm (before the clip: a reduction done twice doubles it)
TRAIN_MESH_LOSS_RTOL = 1e-2
# bf16, after one step, each leaf against 1x1's. mu (0.1 of the clipped
# gradient) as ||mu - mu_1x1|| / ||mu_1x1||: the same bf16 gradient summed in
# other orders; a data row's part lost, or a reduction missing, moves it by
# ~0.5 or more. The params as the share of a leaf's elements that differ:
# both start from the same bf16 weights and Adam's first step is lr·g/(|g| +
# eps) ≈ ±lr plus the same decay, so an element differs only where the
# gradient's sign is in doubt (|g| at its rounding noise, or near eps: many
# of w_down's elements, 4% of block 0's on an H100); a leaf stepped twice, or
# by a wrong gradient, differs in a quarter of its elements or more
TRAIN_MESH_MU_RTOL = 1e-1
TRAIN_MESH_PARAM_SHARE = 0.12
# fp32: the JAX package's own tolerance for a sharded step
MESH_FP32_RTOL = 2e-4


def _reckoned_mesh_train_bytes(cfg, batch: int, seq: int, dp: int,
                               mp: int) -> dict:
    """The peak of one sharded step, reckoned before the run: the state's
    pieces (bf16 params, f32 mu and nu: no leaf of olmo-1b is replicated
    at these meshes), the seeded weights kept to place every mesh, each
    coordinate's weights gathered over "data" (whole over the data axis:
    dp copies of the model in all) and their gradients, the reduced
    gradient pieces, and the activations: under remat "block" each period's
    input kept on every model shard (mp replicas of [B, S, D]), one period
    recomputed for one row at a time (its naive attention's f32 scores,
    mask add, exp and probabilities, [B/dp, H, S, S] each over the row's
    shards, and its MLP's three [B/dp, S, F] products), and the
    vocab-parallel head's f32 logits, their exp and their gradient
    ([B, S, V] f32 each over the shards) and the product at the model
    dtype."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    n = _weight_bytes(cfg) // el
    tok = batch * seq
    return {
        "state": n * el + 2 * n * 4,
        "seeded weights": n * el,
        "gathered weights and gradients": 2 * dp * n * el,
        "reduced gradients": n * el,
        "activations": (mp * cfg.num_layers * tok * cfg.d_model * el
                        + 4 * (batch // dp) * cfg.num_heads * seq * seq * 4
                        + 3 * (tok // dp) * cfg.d_ff * el
                        + tok * cfg.vocab_size * (3 * 4 + el)),
    }


def _joined_leaves(state):
    """Each leaf of a sharded state's params and mu, joined one at a time:
    yields ("params" or "mu", key, the global tensor on the card)."""
    from repro_torch.distributed import sharding as shd

    p_spec, mu_spec = state.specs
    for tree, specs, name in ((state.params, p_spec, "params"),
                              (state.opt.mu, mu_spec, "mu")):
        for k, pieces in tree.items():
            yield name, k, shd.unshard(pieces, specs[k], state.mesh)


def _check_replicas(state) -> int:
    """The number of leaf pieces that have replicas, after checking every
    replica equal to the first bit for bit, and every coordinate's step
    counter equal."""
    from repro_torch.distributed import sharding as shd

    mesh = state.mesh
    replicated = 0
    p_spec, mu_spec = state.specs
    for tree, specs in ((state.params, p_spec), (state.opt.mu, mu_spec),
                        (state.opt.nu, mu_spec)):
        for k, pieces in tree.items():
            seen: dict = {}
            for c, t in pieces.items():
                split = {a for e in specs[k] for a in shd.spec_axes(e)}
                key = tuple(c[i] for i, a in enumerate(mesh.axis_names)
                            if a in split)
                seen.setdefault(key, []).append(t)
            for ts in seen.values():
                if len(ts) > 1:
                    replicated += len(ts)
                    check(all(torch.equal(t, ts[0]) for t in ts[1:]),
                          f"train mesh {mesh.shape}: replicas of {k} differ")
    steps_ = {int(t) for t in state.opt.step.values()}
    check(len(steps_) == 1, f"train mesh: step counters differ: {steps_}")
    return replicated


def _first_step_vs(state, base: dict | None) -> tuple[dict, dict]:
    """After one step: with ``base`` None, every leaf's params and mu
    joined onto the host (1x1's, the base); else each leaf held against the
    base (mu by TRAIN_MESH_MU_RTOL, params by TRAIN_MESH_PARAM_SHARE) ->
    (the base, the worst of each check with its leaf)."""
    if base is None:
        return {(n, k): t.cpu() for n, k, t in _joined_leaves(state)}, {}
    worst = {"mu": (0.0, ""), "params": (0.0, "")}
    for name, k, t in _joined_leaves(state):
        want = base[name, k].to(t.device)
        if name == "mu":
            gap = float(torch.linalg.vector_norm(t - want)
                        / torch.linalg.vector_norm(want).clamp(min=1e-30))
        else:
            gap = float((t != want).float().mean())
        worst[name] = max(worst[name], (gap, k))
        del t, want
    name = f"train mesh {state.mesh.shape}"
    check(worst["mu"][0] <= TRAIN_MESH_MU_RTOL,
          f"{name}: mu after one step differs from 1x1's by {worst['mu']} "
          f"(relative, limit {TRAIN_MESH_MU_RTOL})")
    check(worst["params"][0] <= TRAIN_MESH_PARAM_SHARE,
          f"{name}: params after one step differ from 1x1's in a share "
          f"{worst['params']} (limit {TRAIN_MESH_PARAM_SHARE})")
    return base, worst


def _train_mesh_full_width() -> dict:
    """olmo-1b at full width and depth: the sharded step at each mesh."""
    from repro_torch import capture_analysis, kernels, models
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = get_config("olmo-1b")
    _release_engines()
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    params = models.init_params(cfg, seed=0, device="cuda")
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    one = _fresh_state(cfg, params={k: v.clone() for k, v in params.items()})
    one, m = steps.make_train_fn(cfg, opt)(one, batch)
    want, want_norm = float(m["loss"]), float(m["grad_norm"])
    del one, m
    _release_engines()
    shape = ShapeSpec("phase17", "train", TRAIN_SEQ, TRAIN_BATCH)
    out, base = {"meshes": {}}, None
    kernels.reset_launch_counts()  # the path's run starts here
    for dp, mp in TRAIN_MESHES:
        name = f"{dp}x{mp}"
        mesh = make_debug_mesh((dp, mp))  # cuda:0 at every coordinate
        state = steps.place_train_state(cfg, _fresh_state(cfg, params=params),
                                        mesh)
        exe = steps.lower_for(cfg, mesh, shape, opt_cfg=opt).compile()
        _release_engines()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(MESH_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, m = exe(state, batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            check(_finite(m["loss"]) and _finite(m["grad_norm"]),
                  f"train mesh {name}: step {i + 1} loss {losses[-1]}")
            if i == 0:
                rel = abs(losses[0] - want) / abs(want)
                norm = float(m["grad_norm"])
                norm_rel = abs(norm - want_norm) / want_norm
                lr1 = float(m["lr"])
                check(rel <= TRAIN_MESH_LOSS_RTOL
                      and norm_rel <= TRAIN_MESH_LOSS_RTOL,
                      f"train mesh {name}: first loss {losses[0]:.6f}, "
                      f"grad_norm {norm:.6f}; one device {want:.6f}, "
                      f"{want_norm:.6f} (relative {rel:.3g}, {norm_rel:.3g}, "
                      f"limit {TRAIN_MESH_LOSS_RTOL})")
                check(lr1 > 0, f"train mesh {name}: the step's lr is {lr1}")
                base, worst = _first_step_vs(state, base)
                # the check's joins out of the steps' peak
                _release_engines()
                torch.cuda.reset_peak_memory_stats()
        peak = torch.cuda.max_memory_allocated()
        replicated = _check_replicas(state)
        rep = capture_analysis.analyze_step(exe, (state, batch), mesh=mesh)
        reck = _reckoned_mesh_train_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ, dp, mp)
        out["meshes"][name] = dict(
            step_ms=statistics.median(ms[1:]), ms=ms, losses=losses,
            peak=peak, reckoned=reck, first=worst, grad_norm=norm,
            collectives=rep["collectives"], flops=rep["flops"],
            mem=rep["mem"])
        vs = ("the base of the checks" if not worst else
              f"mu relative {worst['mu'][0]:.3g} at {worst['mu'][1]} (limit "
              f"{TRAIN_MESH_MU_RTOL}), params differing in a share "
              f"{worst['params'][0]:.3g} at {worst['params'][1]} (limit "
              f"{TRAIN_MESH_PARAM_SHARE})")
        log(f"[train-mesh:olmo-1b] {name}: FSDP over data x TP over model on "
            f"logical devices of this card, bf16, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, {MESH_TRAIN_STEPS} steps (peak_lr "
            f"{opt.peak_lr:g}, step 1's lr {lr1:.3g}): losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f" (one device's first {want:.4f}) | step 1's grad_norm "
            f"{norm:.6f} (one device's {want_norm:.6f}) | after one step vs "
            f"1x1: {vs} | "
            + (f"{replicated} replicated pieces equal bit for bit"
               if replicated else "no leaf replicated at this mesh")
            + f", step counters equal on {mesh.size} coordinates | step ms "
            f"(CUDA events) median {out['meshes'][name]['step_ms']:.3f} of "
            f"steps 2-{MESH_TRAIN_STEPS} (all: "
            + ", ".join(f"{x:.1f}" for x in ms)
            + f") | peak of steps 2-{MESH_TRAIN_STEPS} {peak / 1e9:.2f} GB, "
            f"reckoned {sum(reck.values()) / 1e9:.2f} GB ("
            + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in reck.items())
            + f") | one more step counted: {rep['flops'] / 1e12:.4f} TFLOP a "
            f"device, collective bytes a device "
            + (", ".join(f"{op} {n / 1e6:.3f} MB"
                         for op, n in rep["collectives"].items()) or "none")
            + f"; mem {rep['mem']} | {_card()}")
        del state, exe, m
        _release_engines()
    out["launches"] = _launches("train mesh (phase 17)", ())
    del params, base, batch
    _release_engines()
    return out


def _mesh_smoke_batch(dev: str) -> dict:
    """8 x 32 tokens of a numpy seed, pads spread unevenly over the rows."""
    import numpy as np

    rng = np.random.default_rng(1)
    tok = rng.integers(0, 256, (8, 32)).astype(np.int32)
    lab = tok.copy()
    lab[0, 5:] = -1
    lab[3, 20:] = -1
    lab[6, :] = -1
    return {"inputs": torch.from_numpy(tok).to(dev),
            "labels": torch.from_numpy(lab).to(dev)}


def _leaf_gap(a: dict, b: dict) -> float:
    """The largest |a - b| of a leaf relative to its largest |b|."""
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               / max(float(b[k].float().abs().max()), 1e-30) for k in b)


def _train_mesh_smoke() -> None:
    """The fp32 smoke config: one sharded step at 2x2 on the card = the
    CPU's at 1x1 (loss, params, mu, nu)."""
    from repro_torch import models
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import steps

    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    shape = ShapeSpec("smoke", "train", 32, 8)
    runs = {}
    for dev, mesh in (("cpu", make_debug_mesh((1, 1), devices=["cpu"])),
                      ("cuda", make_debug_mesh((2, 2)))):
        state = steps.place_train_state(
            cfg, _fresh_state(cfg, params={k: v.to(dev).clone()
                                           for k, v in params.items()}),
            mesh)
        state, m = steps.lower_for(cfg, mesh, shape).compile()(
            state, _mesh_smoke_batch(dev))
        runs[dev] = (float(m["loss"]), fsdp.unshard_state(state, "cpu"))
    (cl, cs), (gl, gs) = runs["cpu"], runs["cuda"]
    rel = abs(gl - cl) / abs(cl)
    gaps = {"params": _leaf_gap(gs.params, cs.params),
            "mu": _leaf_gap(gs.opt.mu, cs.opt.mu),
            "nu": _leaf_gap(gs.opt.nu, cs.opt.nu)}
    check(rel <= MESH_FP32_RTOL and max(gaps.values()) <= MESH_FP32_RTOL,
          f"train mesh smoke: card 2x2 loss {gl} vs CPU 1x1 {cl}, state "
          f"{gaps}")
    log(f"[train-mesh:smoke] olmo-1b smoke (fp32): one sharded step at 2x2 "
        f"on the card = the CPU's at 1x1: loss {gl:.6f} vs {cl:.6f} "
        f"(relative {rel:.3g}), state relative "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (limit {MESH_FP32_RTOL})")


def _train_mesh_elastic() -> None:
    """A 2-layer fp32 cut at olmo-1b's widths: step at 2x2, save, restore
    (= the saved state bit for bit), place onto 1x2, step = two
    uninterrupted steps at 1x1 (loss, params, mu, nu)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import models
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(
        _depth_cut(get_config("olmo-1b"), 2, "train-mesh"),
        dtype="float32")
    params = models.init_params(cfg, seed=0, device="cuda")
    batch = _device_batch(cfg, 4, 128)
    shape = ShapeSpec("elastic", "train", 128, 4)

    def placed(dp: int, mp: int, state=None):
        mesh = make_debug_mesh((dp, mp))
        state = state or _fresh_state(cfg, params={k: v.clone() for k, v in
                                                   params.items()})
        return (steps.place_train_state(cfg, state, mesh),
                steps.lower_for(cfg, mesh, shape).compile())

    state, exe = placed(1, 1)
    for _ in range(2):
        state, m = exe(state, batch)
    want = float(m["loss"])
    want_state = _train_leaves(fsdp.unshard_state(state, "cpu"))
    del state, exe
    tmp = Path(tempfile.mkdtemp(prefix="repro-torch-elastic-"))
    try:
        state, exe = placed(2, 2)
        state, _ = exe(state, batch)
        saved = fsdp.unshard_state(state, "cpu")
        mgr = CheckpointManager(tmp, async_write=False)
        t0 = time.perf_counter()
        mgr.save(1, state)
        t_save = time.perf_counter() - t0
        del state, exe
        template = _fresh_state(cfg, device="cpu", params={
            k: torch.empty(v.shape, dtype=v.dtype) for k, v in params.items()})
        step, restored = mgr.restore(template)
        check(step == 1, f"train mesh elastic: restored step {step}")
        back = _train_leaves(restored)
        differ = [k for k, v in _train_leaves(saved).items()
                  if not torch.equal(back[k], v)]
        check(not differ, f"train mesh elastic: the restored state differs "
              f"from the saved 2x2 state in {differ[:4]}")
        del saved, back
        state, exe = placed(1, 2, restored)
        state, m = exe(state, batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = float(m["loss"])
    rel = abs(got - want) / abs(want)
    have = _train_leaves(fsdp.unshard_state(state, "cpu"))
    gaps = {t: _leaf_gap({k: v for k, v in have.items()
                          if k.startswith(t + "/")},
                         {k: v for k, v in want_state.items()
                          if k.startswith(t + "/")})
            for t in ("params", "mu", "nu")}
    check(rel <= MESH_FP32_RTOL and max(gaps.values()) <= MESH_FP32_RTOL,
          f"train mesh elastic: 2x2 + save + restore + 1x2 loss {got} vs "
          f"uninterrupted {want}, state {gaps}")
    log(f"[train-mesh:elastic] 2-layer cut, fp32, 4 x 128: a step at 2x2, "
        f"save ({t_save:.2f}s), restore (params, mu, nu and step = the saved "
        f"state bit for bit), place onto 1x2, a step = two uninterrupted "
        f"steps at 1x1: loss {got:.6f} vs {want:.6f} (relative {rel:.3g}), "
        f"state relative " + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (limit {MESH_FP32_RTOL})")
    del state, exe, params, have, want_state
    _release_engines()


def train_mesh_phase() -> dict:
    """Phase 17 (module docstring)."""
    t0 = time.perf_counter()
    out = _train_mesh_full_width()
    _train_mesh_smoke()
    _train_mesh_elastic()
    out["seconds"] = time.perf_counter() - t0
    log(f"[train-mesh] phase 17 passed in {out['seconds']:.1f}s | {_card()}")
    return out


# ----------------------- phase 13 (the mesh coordinate, disagg, the report)
# olmo-1b at full width (bf16), 8 slots, page 16, chunk 64, max_len 1024;
# the decode mesh "1x1" and the prefill slice "1x1@1", both on this card
# (``devices``): two pools, the page handoff a device-local copy, and
# prefill and decode sharing the SMs.
DISAGG_ECFG = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64,
                   mesh="1x1", meshes=("1x1@1",),
                   devices=("cuda:0", "cuda:0"))
DISAGG_LONG, DISAGG_PROMPT = 12, 512


def _disagg_traffic(cfg, seed: int = 0) -> list:
    """The reference's ``mixed()`` stream (``tests/test_disagg.py``) at full
    width: one decode-heavy request (prompt 64, 256 new tokens) beside 12
    prompts of 512 with 4 new tokens each, all arriving at 0."""
    import numpy as np

    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=0, new_tokens=256, greedy=True, arrival_s=0.0,
                    prompt=tuple(int(x) for x in
                                 rng.integers(0, cfg.vocab_size, 64)))]
    for _ in range(DISAGG_LONG):
        reqs.append(Request(
            rid=len(reqs), new_tokens=4, greedy=True, arrival_s=0.0,
            prompt=tuple(int(x) for x in
                         rng.integers(0, cfg.vocab_size, DISAGG_PROMPT))))
    return reqs


def _disagg_arm(eng, cfg, label: str, slices: tuple = ("1x1", "1x1@1"),
                **kw) -> tuple:
    """One stream of ``_disagg_traffic`` through ``run_paged_stream`` under
    a step clock, its own path: the kernels' counts set to 0 just before
    and read just after, each held to the targets' replays in the run, per
    slice (``slices``: the decode mesh and the prefill slice). Returns
    (tokens, report, counts, counts by slice)."""
    from repro_torch import kernels
    from repro_torch.runtime.serve import run_paged_stream

    reqs = _disagg_traffic(cfg)
    before = {m: _lane_launches(eng, m)[0] for m in slices}
    kernels.reset_launch_counts()
    rep = run_paged_stream(eng, reqs, slots=8, clock=_StepClock(), **kw)
    torch.cuda.synchronize()
    after = {m: _lane_launches(eng, m)[0] for m in slices}
    ran = {m: {k: n - before[m].get(k, 0) for k, n in after[m].items()}
           for m in after}
    total = {k: sum(ran[m].get(k, 0) for m in slices)
             for k in set().union(*ran.values())}
    launches = _launches(label, tuple(k for k, n in total.items() if n))
    for name, n in total.items():
        check(launches[name] == n,
              f"{label}: {name} launched {launches[name]} times, the "
              f"replays of both slices reckon {n} ({ran})")
    _check_stream(label, cfg, reqs, rep)
    check(rep["compiles_after_warmup"] == 0,
          f"{label}: {rep['compiles_after_warmup']} captures after warmup")
    return reqs, rep, launches, ran


def _split_equals_shared(label: str, cfg, params, shared, split,
                         kv_dtype: str) -> int:
    """The split's greedy tokens against the shared stream's, request by
    request: equal, or the first divergence is a near-tie of the plain
    attention's logits (``_card_near_tie``, ``BF16_TIE_MARGIN``) — the
    split ingests prompts in other chunks (its chunk budget is the whole
    token budget), so a bf16 product may round otherwise. Returns the
    near-tie count."""
    ties = 0
    for r, d in zip(shared, split):
        if r.tokens == d.tokens:
            continue
        i = next(i for i, (x, y) in enumerate(zip(r.tokens, d.tokens))
                 if x != y)
        ok, gap = _card_near_tie(cfg, params,
                                 list(r.effective_prompt) + r.tokens[:i],
                                 r.tokens[i], d.tokens[i], kv_dtype)
        check(ok, f"{label}: rid {r.rid} split and shared greedy streams "
              f"differ at token {i}, logit gap {gap:.4f} >= "
              f"{BF16_TIE_MARGIN}")
        ties += 1
    return ties


def _disagg_rebind_arm(eng, cfg) -> dict:
    """The reference's split -> collapse -> split loop (collapse at step 4,
    re-split at step 8) on the full-width stream."""
    cb = eng.paged_continuous(slots=8, disagg=True)
    r0 = eng.telemetry.registry.value("disagg_rebinds_total")
    pending, done, t, i = _disagg_traffic(cfg, seed=3), [], 0.0, 0
    n = len(pending)
    while pending or cb.has_work:
        if i == 4:
            cb.set_disagg(False, now=t)
        elif i == 8:
            cb.set_disagg(True, now=t)
        if pending and cb.free_slots:
            take = min(len(pending), cb.free_slots)
            cb.admit(pending[:take], now=t)
            del pending[:take]
        done += cb.step(now=t)
        i += 1
        t += 0.05
        check(i < 4000, "disagg rebind arm did not drain")
    done += cb.flush()
    rebinds = int(eng.telemetry.registry.value("disagg_rebinds_total") - r0)
    check(len(done) == n and rebinds == 2 and eng.post_warmup_compiles == 0,
          f"disagg split -> collapse -> split: {len(done)}/{n} finished, "
          f"{rebinds} rebinds, {eng.post_warmup_compiles} captures")
    return {"rebinds": rebinds, "migrations": cb.stats.migrations,
            "migrated_pages": cb.stats.migrated_pages}, cb


def _time_transport(cb, pages: int = 30, tag: str = "disagg") -> dict:
    """One migration's device time: the prefill slice's ``mg`` gather, the
    block's move and the decode slice's scatter of ``pages`` pages (the
    stream's mean is 388 / 13 = 29.8; the targets always move the 64-page
    cap, padded with the null page), by CUDA events over 20 calls after 3
    warm ones, on pages the drained stream left free. The bound: the
    64-page block read and written by the gather, by the copy into the
    scatter's static input and by the scatter."""
    from repro_torch import roofline

    ids = list(range(1, pages + 1))
    run = partial(cb._transport, cb._pf_cache, cb._cache, ids, ids)
    for _ in range(3):
        run()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        run()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / 20
    block = sum(t[:, :64].numel() * t.element_size()
                for layer in cb._cache for t in layer.values())
    bound_ms = 6 * block / roofline.HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] one migration of {pages} pages (a 64-page block of "
        f"{block / 1e6:.1f} MB): {ms:.4f} ms by CUDA events, "
        f"{ms / pages:.5f} ms a page, bound {bound_ms:.4f} ms (the block "
        f"read and written three times at 3.35 TB/s) | {_card()}")
    return {"migration_ms": ms, "migration_ms_per_page": ms / pages,
            "migration_bound_ms": bound_ms}


def _disagg_trie(eng, cfg) -> dict:
    """A prompt repeated after its pages migrated: the second request
    adopts them from the prefix trie and decodes the same tail."""
    import numpy as np

    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.serve import run_paged_stream

    prompt = tuple(int(x) for x in np.random.default_rng(7).integers(
        0, cfg.vocab_size, DISAGG_PROMPT))
    a, b = (Request(rid=i, new_tokens=4, greedy=True, arrival_s=5.0 * i,
                    prompt=prompt) for i in range(2))
    rep = run_paged_stream(eng, [a, b], slots=8, disagg=True,
                           clock=_StepClock())
    check(rep["migrations"] > 0 and rep["shared_prompt_tokens"] > 0
          and a.tokens == b.tokens and rep["compiles_after_warmup"] == 0,
          f"disagg trie after a migrated fork: migrations "
          f"{rep['migrations']}, shared {rep['shared_prompt_tokens']}, "
          f"tails {a.tokens} / {b.tokens}")
    return {"shared_prompt_tokens": rep["shared_prompt_tokens"]}


def _b4_never_written_lead() -> float:
    """B4's tensor-core body where a never-written row (a zeroed pool's
    scale 0) leads a query row's tile: the chunk's later rows see a last
    page whose rows past the frontier are zero, and every written key
    scores below 0. Before PR 27 the body took 1 / 0 there and the row came
    out NaN (its K/V then reached the null page). Finite, = plain."""
    from repro_torch import kernels
    from repro_torch.models import quantise_kv_rows

    g = torch.Generator().manual_seed(6)
    kq, ks = quantise_kv_rows(torch.randn(8, 16, 2, 128, generator=g))
    vq, vs = quantise_kv_rows(torch.randn(8, 16, 2, 128, generator=g))
    kq = -kq.abs()
    for t in (kq, vq, ks, vs):
        t[5, 8:] = 0
    q = torch.ones(1, 64, 2, 128, dtype=torch.bfloat16)
    bt = torch.tensor([[3, 5, 0, 0]], dtype=torch.int32)
    st = torch.zeros(1, dtype=torch.int32)
    args = [t.to("cuda") for t in (q, kq, vq, ks, vs, bt, st)]
    saved = kernels.paged_prefill_attention_int8.launches
    out = kernels.paged_prefill_attention_int8(*args)
    kernels.paged_prefill_attention_int8.launches = saved
    ref = kernels.paged_prefill_attention_int8_plain(args[0].float(),
                                                     *args[1:])
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    check(bool(torch.isfinite(out.float()).all())
          and err <= KERNEL_ATOL[torch.bfloat16],
          f"B4 with a never-written row leading: finite "
          f"{bool(torch.isfinite(out.float()).all())}, max abs err {err}")
    return err


def _pool_bytes(eng, kv_dtype: str, mesh: str) -> int:
    return sum(t.numel() * t.element_size()
               for layer in eng.paged_cache(kv_dtype, mesh)
               for t in layer.values())


def _capture_rows(eng, dtype: str) -> dict:
    """The capture report of the ``cbp`` (16-page bucket), ``pf`` (chunk
    64) and ``mg`` keys, and the replayed ``cbp`` / ``pf`` steps against
    the roofline floor of their report."""
    from repro_torch.core import lanes

    reps = {str(r["key"]): r for r in eng.telemetry.compile_reports}
    bad = [k for k, r in reps.items() if "error" in r]
    check(not bad, f"capture report: errors at {bad[:3]}: "
          f"{[reps[k]['error'] for k in bad[:3]]}")
    rows = {}
    for name, key in (
        ("cbp", lanes.CBP.key(8, 16, dtype, "1x1")),
        ("pf", lanes.PF.key(8, 64, dtype, "1x1")),
        ("mg gather", lanes.MG.key("gather", dtype, "1x1@1")),
        ("mg scatter", lanes.MG.key("scatter", dtype, "1x1")),
    ):
        r = reps[str(key)]
        t = r["roofline"]
        floor_ms = max(t["ideal_compute_s"], t["ideal_memory_s"]) * 1e3
        row = {"flops": r["flops"], "bytes": r["bytes"],
               "kernel_flop_share": (r["kernel_flops"] / r["flops"]
                                     if r["flops"] else 0.0),
               "capture_ms": r["build_ms"], "floor_ms": floor_ms}
        if name in ("cbp", "pf"):
            row["step_ms"] = _wall_ms(_step_runs(eng, name, 8), steps=20)
        rows[name] = row
        log(f"[disagg:capture] {name} {key}: {r['flops'] / 1e9:.3f} GFLOP, "
            f"{r['bytes'] / 1e9:.3f} GB counted (every op's inputs and "
            f"outputs), kernels {100 * row['kernel_flop_share']:.1f}% of "
            f"the flops, capture {r['build_ms']:.1f} ms, roofline floor "
            f"{floor_ms:.4f} ms ({r['param_bytes'] / 1e9:.3f} GB weights + "
            f"{r['cache_extent_bytes'] / 1e9:.4f} GB cache extent at 3.35 "
            f"TB/s)" + (f"; replayed step {row['step_ms']:.4f} ms wall, "
                        f"{row['step_ms'] / floor_ms:.1f}x the floor"
                        if "step_ms" in row else "") + f" | {_card()}")
    return rows


def _capture_smoke_card_vs_cpu() -> int:
    """The smoke config's capture report on the card equals a CPU engine's,
    key for key (flops, bytes, transcendentals, the kernels' share): the
    kernels add their reckoning at the key's shapes on both devices."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.runtime.serve import Engine, EngineConfig

    cfg = get_config("olmo-1b").smoke()
    params = models.init_params(cfg, seed=0)
    reps = {}
    for dev in ("cuda", "cpu"):
        tel = Telemetry(compile_analysis=True)
        ecfg = EngineConfig(max_len=48, max_batch=4, page_size=8,
                            num_pages=40, prefill_chunk=8, mesh="1x1",
                            meshes=("1x1@1",), devices=(dev, dev))
        with Engine(cfg, params, ecfg, telemetry=tel, device=dev) as eng:
            eng.paged_continuous(slots=4, disagg=True)
        reps[dev] = {str(r["key"]): r for r in tel.compile_reports}
    fields = ("flops", "bytes", "transcendentals", "kernel_flops",
              "kernel_bytes")
    check(sorted(reps["cuda"]) == sorted(reps["cpu"]),
          "capture report: the card's keys differ from the CPU's")
    for k, r in reps["cuda"].items():
        got = [r.get(f) for f in fields]
        want = [reps["cpu"][k].get(f) for f in fields]
        check(got == want, f"capture report {k}: card {got} != cpu {want}")
    return len(reps["cuda"])


def _start_disagg_launcher() -> tuple:
    """The launcher's mesh and capture flags as a user runs them: a
    subprocess on the card (smoke config), started at the phase's start so
    its process start-up overlaps the full-width streams (the card is
    shared; the phase's timings are taken after it has ended)."""
    import os
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    path = tmp / "compile.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--engine", "paged", "--prompt-len", "24", "--prefill-chunk",
           "8", "--requests", "4", "--meshes", "1x1@1", "--disagg",
           "--devices", "cuda:0 cuda:0", "--compile-report", str(path),
           "--json"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = open(tmp / "stdout", "w"), open(tmp / "stderr", "w")
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, cwd=ROOT, env=env)
    return proc, tmp, (out, err)


def _finish_disagg_launcher(proc, tmp: Path, files: tuple) -> dict:
    """Wait for the launcher; exit 0, one report entry per captured key,
    none an error, migrations, 0 captures after warmup."""
    import shutil

    try:
        rc = proc.wait(timeout=300)
        for f in files:
            f.close()
        text = (tmp / "stdout").read_text()
        check(rc == 0, f"launcher disagg: exit {rc}: "
              f"{(tmp / 'stderr').read_text()[-2000:]}")
        rep = json.loads(text[text.index("{\n"):])
        entries = json.loads((tmp / "compile.json").read_text())
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    keys = {e["key"] for e in entries}
    check(len(keys) == len(entries) == rep["compiles_total"]
          and rep["migrations"] > 0 and rep["compiles_after_warmup"] == 0
          and not any("error" in e for e in entries),
          f"launcher disagg: {len(entries)} report entries, "
          f"{rep['compiles_total']} captures, {rep['migrations']} migrations")
    log(f"[disagg:launcher] python -m repro_torch.launch.serve --smoke "
        f"--engine paged --meshes 1x1@1 --disagg --devices 'cuda:0 cuda:0' "
        f"--compile-report on the card: exit 0, {rep['finished']} finished, "
        f"{rep['migrations']} migrations of {rep['migrated_pages']} pages, "
        f"{len(entries)} report entries, one per captured key")
    return rep


def disagg_phase(cfg, params) -> dict:
    """Phase 13: the mesh coordinate and disaggregated prefill/decode on one
    card, and the capture report. The launcher's run starts first, beside
    the rest; then B4 with a never-written row leading a tile. On the bf16
    pool (the engine warmed with
    the capture report on) and the int8 pool, shared then disaggregated,
    sync then async: the disaggregated greedy tokens equal the shared
    ones, every prompt migrates its pages (``migrated_pages`` = the pages
    its prompt fills), 0 captures after warmup, each kernel's launches =
    the replays' reckoning per slice; then a split -> collapse -> split
    run (2 rebinds) and one migration's device time, a prompt repeated
    after its migration (a trie hit, the same tail), the two slices' pools
    distinct storage, the peak
    against the reckoned bytes (weights + two pools); the report's rows,
    the smoke report card = CPU, and the launcher. Returns the seconds
    and each arm's counts."""
    _release_engines()
    t0 = time.perf_counter()
    launcher = _start_disagg_launcher()
    try:
        return _disagg_phase(cfg, params, launcher, t0)
    finally:
        if launcher[0].poll() is None:  # a check failed before its wait
            launcher[0].kill()


def _disagg_phase(cfg, params, launcher: tuple, t0: float) -> dict:
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.runtime.serve import Engine, EngineConfig

    err = _b4_never_written_lead()
    log(f"[disagg] B4 (tensor-core body) with a never-written row leading "
        f"a tile: finite, max abs err {err:.3g} against the plain version")
    log(f"[disagg] both slices of the split on one card: devices "
        f"{DISAGG_ECFG['devices']}, decode mesh 1x1 and prefill slice "
        f"1x1@1 — the page handoff is a device-local copy and prefill and "
        f"decode share the SMs, so this phase shows the semantics and the "
        f"handoff's cost, not the speed of disaggregation | {_card()}")
    ps = DISAGG_ECFG["page_size"]
    pages = -(-64 // ps) + DISAGG_LONG * -(-DISAGG_PROMPT // ps)
    paths, out = {}, {}
    for dt in ("fp32", "int8"):
        tag = "bf16" if dt == "fp32" else "int8"
        torch.cuda.reset_peak_memory_stats()
        tel = Telemetry(compile_analysis=dt == "fp32")
        with Engine(cfg, params, EngineConfig(kv_dtype=dt, **DISAGG_ECFG),
                    telemetry=tel) as eng:
            for async_steps in (False, True):
                mode = "async" if async_steps else "sync"
                t_shared = time.perf_counter()
                shared, rs, _, _ = _disagg_arm(
                    eng, cfg, f"disagg {tag} {mode} shared",
                    async_steps=async_steps)
                t_shared = time.perf_counter() - t_shared
                t_arm = time.perf_counter()
                split, rd, ld, by_slice = _disagg_arm(
                    eng, cfg, f"disagg {tag} {mode} split", disagg=True,
                    async_steps=async_steps)
                t_arm = time.perf_counter() - t_arm
                ties = _split_equals_shared(f"disagg {tag} {mode}", cfg,
                                            params, shared, split, dt)
                out.setdefault("ties", {})[f"{tag} {mode}"] = ties
                # phase 16 holds its multi-device splits to these
                out.setdefault("shared", {})[f"{tag} {mode}"] = shared
                out.setdefault("split", {})[f"{tag} {mode}"] = (
                    rd["migrations"], rd["migrated_pages"])
                check(rd["migrations"] >= DISAGG_LONG
                      and rd["migrated_pages"] == pages,
                      f"disagg {tag} {mode}: {rd['migrations']} migrations "
                      f"of {rd['migrated_pages']} pages, reckoned {pages}")
                paths[f"disagg {tag} {mode}"] = ld
                log(f"[disagg] {tag} {mode}: tokens = shared on "
                    f"{len(split) - ties} of {len(split)} requests, {ties} "
                    f"near-tie divergences ({sum(len(r.tokens) for r in split)}"
                    f" tokens), {rd['migrations']} "
                    f"migrations of {rd['migrated_pages']} pages, lanes "
                    f"{rd['lane_steps']}, 0 captures after warmup; launches "
                    f"per slice (decode 1x1 / prefill 1x1@1): "
                    + "; ".join(f"{k} {by_slice['1x1'].get(k, 0)} / "
                                f"{by_slice['1x1@1'].get(k, 0)}"
                                for k in sorted(ld) if ld[k])
                    + f"; wall incl. its batcher's warm replays: split "
                    f"{t_arm:.2f} s, shared {t_shared:.2f} s; step-clock "
                    f"span shared {rs['span_s']:.3f} s / split "
                    f"{rd['span_s']:.3f} s | {_card()}")
            if dt == "fp32":
                out["rebind"], split_cb = _disagg_rebind_arm(eng, cfg)
                out["trie"] = _disagg_trie(eng, cfg)
                t_wait = time.perf_counter()
                _finish_disagg_launcher(*launcher)
                t_wait = time.perf_counter() - t_wait
                out["rebind"].update(_time_transport(split_cb))
                out["capture"] = _capture_rows(eng, dt)
            dec, pf = eng.paged_cache(dt, "1x1"), eng.paged_cache(dt, "1x1@1")
            check(all(a[n].data_ptr() != b[n].data_ptr()
                      for a, b in zip(dec, pf) for n in a),
                  f"disagg {tag}: the two slices' pools share storage")
            reckoned = (sum(t.numel() * t.element_size()
                            for t in params.values())
                        + _pool_bytes(eng, dt, "1x1")
                        + _pool_bytes(eng, dt, "1x1@1"))
            peak = torch.cuda.max_memory_allocated()
            log(f"[disagg] {tag}: peak {peak / 1e9:.2f} GB against "
                f"{reckoned / 1e9:.2f} GB reckoned (weights + two pools of "
                f"{_pool_bytes(eng, dt, '1x1') / 1e9:.3f} GB); the pools' "
                f"storage is distinct | {_card()}")
            out[f"peak_{tag}_gb"] = peak / 1e9
        del eng  # its pools and graphs go before the next engine's peak
        _release_engines()
    t_smoke = time.perf_counter()
    n_keys = _capture_smoke_card_vs_cpu()
    log(f"[disagg:capture] smoke olmo-1b: the card's report equals the "
        f"CPU's on all {n_keys} keys (flops, bytes, transcendentals, the "
        f"kernels' share)")
    end = time.perf_counter()
    out["seconds"] = end - t0
    out["paths"] = paths
    log(f"[disagg] phase 13 passed in {out['seconds']:.1f}s (full-width "
        f"engines {t_smoke - t0:.1f}s, of which {t_wait:.1f}s waiting for "
        f"the launcher run beside them; smoke report card vs CPU "
        f"{end - t_smoke:.1f}s): "
        f"split -> collapse -> split {out['rebind']['rebinds']} rebinds, "
        f"trie hit {out['trie']['shared_prompt_tokens']} shared prompt "
        f"tokens after a migration | {_card()}")
    return out


# ------------------- phase 14 (meshes of more than one logical device)
# olmo-1b at full width (bf16), 8 slots, page 16, chunk 64, max_len 1024,
# four logical devices that all name this card, and the ladder 1x1 / 1x2 /
# 2x1 / 2x2: each mesh its own pool and CUDA graphs, the 2-way meshes'
# weights split over "model" (one set of pieces, shared by 1x2 and 2x2).
MESH_ECFG = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64,
                 mesh="1x1", meshes=("1x2", "2x1", "2x2"),
                 devices=("cuda:0",) * 4)
MESH_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                "sample_rows")


def _mesh_stream(eng, reqs, mesh: str, flips: dict | None = None, *,
                 engine: str = "paged", spec: bool | None = None) -> tuple:
    """``reqs`` through ``run_paged_stream`` (``engine`` "paged") or
    ``run_continuous_stream`` ("dense", its batcher built with
    ``spec_decode=spec``) at ``mesh`` under a ``_BatcherClock`` (one
    schedule at every mesh), with ``flips`` {batcher step: mesh} rebinding
    before that step. Returns the report and the key (uint32 pair) each
    request's token i was drawn with, which a sampled token's near-tie
    check needs."""
    from repro_torch.runtime.serve import (
        run_continuous_stream,
        run_paged_stream,
    )

    clock, keys = _BatcherClock(), {}
    by_rid = {r.rid: r for r in reqs}
    name = "paged_continuous" if engine == "paged" else "continuous"
    make = getattr(eng, name)

    def logged_batcher(**kw):
        if spec is not None:
            kw["spec_decode"] = spec
        cb = clock.bind(make(**kw))
        step = cb.step

        def logged(now: float = 0.0):
            to = (flips or {}).get(cb.stats.steps)
            if to is not None and cb.mesh != to:
                cb.set_mesh(to, now=now)
            seated = {r.rid: (len(r.tokens), cb._keys[s].copy())
                      for s, r in enumerate(cb._slots) if r is not None}
            out = step(now)
            for rid, (n, key) in seated.items():
                if len(by_rid[rid].tokens) > n:
                    keys[rid, n] = key
            return out

        cb.step = logged
        return cb

    setattr(eng, name, logged_batcher)
    run = run_paged_stream if engine == "paged" else run_continuous_stream
    try:
        rep = run(eng, reqs, slots=8, seed=0, clock=clock, mesh=mesh)
    finally:
        delattr(eng, name)
    torch.cuda.synchronize()
    return rep, keys


def _card_score_near_tie(cfg, params, seq, a: int, b: int, key,
                         temperature: float,
                         kv_dtype: str = "fp32") -> tuple[bool, float]:
    """``_card_near_tie`` for a sampled token: the sampler's scores
    (``gumbel + logits / t`` under the row's key at that token,
    ``kernels.sampling.sample_scores_plain``) of ``a`` and ``b`` lie within
    ``BF16_TIE_MARGIN``."""
    import numpy as np

    from repro_torch.kernels import sampling

    row = _card_logits(cfg, params, seq, kv_dtype)
    k = torch.from_numpy(np.asarray(key, np.uint32).view(np.int32)).cuda()
    scores = sampling.sample_scores_plain(
        row[None], torch.tensor([temperature], device="cuda"),
        torch.zeros(1, dtype=torch.bool, device="cuda"), k[None])[0]
    gap = abs(float(scores[a] - scores[b]))
    return gap < BF16_TIE_MARGIN, gap


def _mesh_equals(label: str, cfg, params, base, got, keys,
                 kv_dtype: str = "fp32") -> int:
    """A mesh's tokens against 1x1's, request by request: equal, or the
    first divergence is a near-tie — of the logits (over pages of
    ``kv_dtype``) for a greedy row, of the sampler's scores under the row's
    key for a sampled one. Returns the near-tie count."""
    ties = 0
    for r, d in zip(base, got):
        if r.tokens == d.tokens:
            continue
        i = next(i for i, (x, y) in enumerate(zip(r.tokens, d.tokens))
                 if x != y)
        seq = list(r.effective_prompt) + r.tokens[:i]
        if r.greedy:
            ok, gap = _card_near_tie(cfg, params, seq, r.tokens[i],
                                     d.tokens[i], kv_dtype)
        else:
            ok, gap = _card_score_near_tie(cfg, params, seq, r.tokens[i],
                                           d.tokens[i], keys[r.rid, i],
                                           r.temperature, kv_dtype)
        check(ok, f"{label}: rid {r.rid} ({'greedy' if r.greedy else 'sampled'}"
              f") differs from 1x1 at token {i}, gap {gap:.4f} >= "
              f"{BF16_TIE_MARGIN}")
        ties += 1
    return ties


def _mesh_arm(eng, cfg, label: str, mesh: str,
              flips: dict | None = None, *, reqs=None, shards: int = 2,
              **stream) -> tuple:
    """One stream (``_shared_prefix_traffic`` unless ``reqs``; ``stream``
    as ``_mesh_stream``), its own path: the kernels' counts set to 0 just
    before and read just after, each held to the targets' replays in the
    run over every mesh (layers x dp x mp per replay of every lane, k x
    draft layers x dp x mp per ``dr`` replay; one ``sample_rows`` a
    sampling step, k per ``dr``); a paged stream's ``pool_shards`` held to
    ``shards`` (the ladder's widest data axis)."""
    from repro_torch import kernels

    reqs = _shared_prefix_traffic(cfg) if reqs is None else reqs
    before = _lane_launches(eng)[0]
    kernels.reset_launch_counts()
    rep, keys = _mesh_stream(eng, reqs, mesh, flips, **stream)
    want = {k: n - before.get(k, 0) for k, n in _lane_launches(eng)[0].items()}
    launches = _launches(label, tuple(k for k, n in want.items() if n))
    for name, n in want.items():
        check(launches[name] == n, f"{label}: {name} launched "
              f"{launches[name]} times, the replays reckon {n}")
    _check_stream(label, cfg, reqs, rep)
    check(rep["compiles_after_warmup"] == 0,
          f"{label}: {rep['compiles_after_warmup']} captures after warmup")
    check(rep.get("pool_shards", shards) == shards, f"{label}: pool_shards "
          f"{rep.get('pool_shards')}")  # the dense engine has no pool
    return reqs, rep, launches, keys


def _mesh_tables(eng, slots: int = 8, pages: int = 16) -> torch.Tensor:
    """Slot s's ``pages`` pages on its own pool shard's block."""
    shards = eng.pool_shards
    blk = eng.pool_physical_pages // shards
    per = slots // shards
    return torch.tensor([[(s * shards // slots) * blk + 1 + (s % per) * pages
                          + j for j in range(pages)] for s in range(slots)],
                        dtype=torch.int32, device="cuda")


def _mesh_step_logits(eng, cfg, moe_policy: str = "drop",
                      label: str = "mesh", hold: bool = True) -> dict:
    """One decode step (8 slots at position 200 over 16-page tables) and
    one prefill chunk (64 rows) at 1x2 and 2x2 against 1x1, on one pool
    content (a copy of 1x1's pool laid out onto each mesh's pieces): the
    eager steps' logits (a MoE stack's under ``moe_policy``), max abs
    difference, held to ``STEP_LOGIT_ATOL`` (with ``hold``; else only
    returned)."""
    from repro_torch import models
    from repro_torch.models import tensor_parallel as tp

    g = torch.Generator().manual_seed(14)
    bt = _mesh_tables(eng)
    tok = torch.randint(0, cfg.vocab_size, (8, 1), generator=g,
                        dtype=torch.int32).cuda()
    chunk = torch.randint(0, cfg.vocab_size, (8, 64), generator=g,
                          dtype=torch.int32).cuda()
    pos = torch.full((8,), 200, dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 64, 128, 192] * 2, dtype=torch.int32,
                         device="cuda")
    length = torch.full((8,), 64, dtype=torch.int32, device="cuda")
    snap = [{n: t.clone() for n, t in d.items()}
            for d in eng.paged_cache("fp32", "1x1")]
    out = {}
    with torch.no_grad():
        for m in ("1x1", "1x2", "2x2"):
            pool, ps = eng.paged_cache("fp32", m), eng._params_for_mesh(m)
            models.relayout_cache(pool, snap)
            kw = dict(moe_policy=moe_policy)
            if m == "1x1":
                dec = models.paged_decode_step(cfg, ps, pool, tok, pos, bt,
                                               **kw)[0]
                models.relayout_cache(pool, snap)
                pf = models.paged_prefill_step(cfg, ps, pool, chunk, start,
                                               bt, length, **kw)[0]
            else:
                lay = eng._layout(m, 8)
                dec = tp.mesh_paged_decode_step(cfg, lay, ps, pool, tok, pos,
                                                bt, **kw)
                models.relayout_cache(pool, snap)
                pf = tp.mesh_paged_prefill_step(cfg, lay, ps, pool, chunk,
                                                start, bt, length, **kw)
            models.relayout_cache(pool, snap)
            out[m] = (dec.float(), pf.float())
    del snap
    errs = {}
    for m in ("1x2", "2x2"):
        errs[m] = [float((a - b).abs().max())
                   for a, b in zip(out[m], out["1x1"])]
        check(all(bool(torch.isfinite(a).all()) for a in out[m]),
              f"{label} {m}: step logits not finite")
        check(not hold or all(e <= STEP_LOGIT_ATOL for e in errs[m]),
              f"{label} {m}: step logits differ from 1x1's by {errs[m]} "
              f"(decode, prefill) > {STEP_LOGIT_ATOL}")
    return errs


def _mesh_replay_ms(eng, mesh: str, steps: int = 5) -> dict:
    """A replayed ``cbp`` step at ``mesh`` (8 slots at position 200,
    16-page tables, token, position and keys chained): host wall per step
    over 20 steps, device busy per step from ``torch.profiler`` (CUDA
    events around queued steps where it records none)."""
    from repro_torch.core import lanes

    i32 = torch.int32
    exe = eng._decode.build(lanes.CBP.key(8, 16, "fp32", mesh))
    state = _steady_args(exe, [
        torch.zeros(8, 1, dtype=i32, device="cuda"),
        torch.full((8,), 200, dtype=i32, device="cuda"), _mesh_tables(eng),
        torch.ones(8, dtype=torch.bool, device="cuda"),
        torch.ones(8, device="cuda"),
        torch.ones(8, dtype=torch.bool, device="cuda"), _row_keys(8)])
    cache = eng.paged_cache("fp32", mesh)

    def run():
        o = exe(cache, *state)
        state[0], state[1], state[6] = o[4], o[2], o[3]
        return o[5].cpu()

    return _replay_ms(run, steps)


def _replay_ms(run, steps: int = 5) -> dict:
    """Host wall per step of ``run`` over 20 steps, device busy per step
    from ``torch.profiler`` (CUDA events around queued steps where it
    records none)."""
    from torch.profiler import ProfilerActivity, profile

    wall = _wall_ms(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    busy, by = sum(_kernel_ms(prof, steps).values()), "profiler"
    if busy == 0:
        busy = _queued_ms(run, torch.empty(1, device="cuda"), steps)
        by = "cuda events"
    return {"wall_ms": wall, "busy_ms": busy, "by": by}


def _mesh_smoke_card_vs_cpu(cell: dict | None = None, engine: str = "paged",
                            meshes: tuple = ("1x2", "2x2"),
                            arch: str = "olmo-1b") -> dict:
    """``arch``'s fp32 smoke config at ``meshes`` (every other request
    sampled): the card's graph targets give the CPU engine's tokens, under
    a step clock; ``cell`` adds to the engine's config (phase 15: an int8
    pool with speculation, the dense engine with speculation)."""
    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.serve import (
        Engine,
        EngineConfig,
        run_continuous_stream,
        run_paged_stream,
    )

    cfg = get_config(arch).smoke()
    params = models.init_params(cfg, seed=0)
    run = run_paged_stream if engine == "paged" else run_continuous_stream
    label = (f"mesh smoke {arch}"
             + ("" if cell is None else f" {engine} {cell}"))
    out = {}
    for mesh in meshes:
        toks = {}
        for dev in ("cuda", "cpu"):
            rng = np.random.default_rng(0)
            rs = [Request(rid=i, new_tokens=6, greedy=i % 2 == 0,
                          temperature=1.0 if i % 2 == 0 else 0.8,
                          arrival_s=0.0, prompt=tuple(
                              int(x) for x in rng.integers(0, cfg.vocab_size,
                                                           12)))
                  for i in range(6)]
            ecfg = EngineConfig(max_len=32, max_batch=4, page_size=8,
                                num_pages=20, prefill_chunk=8, mesh=mesh,
                                devices=(dev,) * 4, **(cell or {}))
            with Engine(cfg, params, ecfg, device=dev) as eng:
                rep = run(eng, rs, slots=4, clock=_StepClock())
            check(rep["compiles_after_warmup"] == 0 and rep["finished"] == 6,
                  f"{label} {mesh} on {dev}: {rep['finished']} finished, "
                  f"{rep['compiles_after_warmup']} captures after warmup")
            if cell and cell.get("spec_k"):
                check(rep["lane_steps"]["verify"] > 0,
                      f"{label} {mesh} on {dev}: lanes {rep['lane_steps']}")
            toks[dev] = [r.tokens for r in rs]
        check(toks["cuda"] == toks["cpu"], f"{label} {mesh}: card "
              f"{toks['cuda']} != CPU {toks['cpu']}")
        out[mesh] = sum(len(t) for t in toks["cuda"])
    return out


def _pipeline_and_collectives() -> dict:
    """``pipeline_forward`` over 4 logical stages on this card against
    ``reference_forward`` (fp32, 8 microbatches of 16 x 256), and
    ``compressed_psum`` over a 4-way axis on the card against the CPU's."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import pipeline
    from repro_torch.distributed.sharding import LogicalMesh

    g = torch.Generator().manual_seed(14)
    n, m, mb, d = 4, 8, 16, 256
    params = {"w": (torch.randn(n, d, d, generator=g) * d ** -0.5).cuda(),
              "b": torch.randn(n, d, generator=g).cuda()}
    xs = torch.randn(m, mb, d, generator=g).cuda()

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    mesh = LogicalMesh((n,), ("stage",), ["cuda:0"] * n)
    got = pipeline.pipeline_forward(stage, params, xs, mesh=mesh)
    ref = pipeline.reference_forward(stage, params, xs)
    err = float((got - ref).abs().max())
    check(err <= 1e-5, f"pipeline_forward over 4 stages: max abs err {err}")
    shards = [torch.randn(64, 128, generator=g) * (i + 1) for i in range(4)]
    cpu = coll.compressed_psum({(i,): s for i, s in enumerate(shards)},
                               LogicalMesh((4,), ("pod",), ["cpu"] * 4),
                               "pod")
    card = coll.compressed_psum({(i,): s.cuda() for i, s in
                                 enumerate(shards)},
                                LogicalMesh((4,), ("pod",), ["cuda:0"] * 4),
                                "pod")
    check(all(torch.equal(card[c].cpu(), cpu[c]) for c in cpu),
          "compressed_psum on the card differs from the CPU's")
    return {"pipeline_err": err,
            "bubble": pipeline.bubble_fraction(n, m)}


def _start_mesh_launcher() -> tuple:
    """``--mesh 1x2 --meshes "1x1 2x2"`` over four logical devices on this
    card, as a user runs it (smoke config), a subprocess started at the
    phase's start."""
    import os
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--engine", "paged", "--requests", "6", "--prefix-len", "16",
           "--prefill-chunk", "16", "--max-len", "64", "--mesh", "1x2",
           "--meshes", "1x1 2x2", "--devices",
           "cuda:0 cuda:0 cuda:0 cuda:0", "--json"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = open(tmp / "stdout", "w"), open(tmp / "stderr", "w")
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, cwd=ROOT, env=env)
    return proc, tmp, (out, err)


def _finish_mesh_launcher(proc, tmp: Path, files: tuple) -> dict:
    import shutil

    try:
        rc = proc.wait(timeout=300)
        for f in files:
            f.close()
        text = (tmp / "stdout").read_text()
        check(rc == 0, f"launcher mesh: exit {rc}: "
              f"{(tmp / 'stderr').read_text()[-2000:]}")
        rep = json.loads(text[text.index("{"):])
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    check(rep["mesh"] == "1x2" and rep["pool_shards"] == 2
          and rep["finished"] == 6 and rep["compiles_after_warmup"] == 0,
          f"launcher mesh: mesh {rep.get('mesh')}, shards "
          f"{rep.get('pool_shards')}, finished {rep.get('finished')}, "
          f"{rep.get('compiles_after_warmup')} captures after warmup")
    log(f"[mesh:launcher] python -m repro_torch.launch.serve --smoke --engine "
        f"paged --mesh 1x2 --meshes '1x1 2x2' --devices 'cuda:0 cuda:0 "
        f"cuda:0 cuda:0' on the card: exit 0, {rep['finished']} finished, "
        f"pool_shards 2, {rep['compiles_total']} captures, 0 after warmup")
    return rep


def mesh_phase(cfg, params) -> dict:
    """Phase 14: paged serving on meshes of more than one logical device,
    all on this card (olmo-1b on its first ``OLMO_CUT_LAYERS`` layers),
    the pipeline and the collectives. The launcher runs
    beside the rest. The bf16 cell's stream at 1x1, 1x2 and 2x2, then
    1x2 -> 2x2 -> 1x1 mid-stream: 0 captures after warmup, 2 rebinds,
    pool_shards 2, each kernel's launches = the replays' reckoning
    (layers x dp x mp per step for B1 and B2, one ``sample_rows``), tokens
    = 1x1's but for near-ties; one step's logits at 1x2 and 2x2 within
    ``STEP_LOGIT_ATOL`` of 1x1's; a replayed ``cbp`` step's wall and busy
    ms at each mesh; the peak against the reckoned bytes; the smoke config
    card = CPU at 1x2 and 2x2; ``pipeline_forward`` and
    ``compressed_psum``."""
    _release_engines()
    t0 = time.perf_counter()
    cfg, params = _depth_view(cfg, params, OLMO_CUT_LAYERS, "mesh")
    launcher = _start_mesh_launcher()
    try:
        return _mesh_phase(cfg, params, launcher, t0)
    finally:
        if launcher[0].poll() is None:
            launcher[0].kill()


def _mesh_phase(cfg, params, launcher: tuple, t0: float) -> dict:
    from repro_torch.runtime.serve import Engine, EngineConfig

    torch.cuda.reset_peak_memory_stats()
    out, paths, arms = {}, {}, {}
    with Engine(cfg, params, EngineConfig(**MESH_ECFG)) as eng:
        check(eng.graphs, "mesh: the engine's targets are not CUDA graphs")
        t_warm = time.perf_counter()
        eng.paged_continuous(slots=8)  # captures every mesh's targets
        t_warm = time.perf_counter() - t_warm
        captures = eng._decode.stats.misses
        for mesh in ("1x1", "1x2", "2x2"):
            arms[mesh] = _mesh_arm(eng, cfg, f"mesh {mesh}", mesh)
        arms["ladder"] = _mesh_arm(eng, cfg, "mesh ladder 1x2 -> 2x2 -> 1x1",
                                   "1x2", flips={20: "2x2", 60: "1x1"})
        r0 = arms["ladder"][1]
        rebinds = int(eng.telemetry.registry.value("mesh_rebinds_total"))
        check(rebinds == 2, f"mesh ladder: {rebinds} rebinds")
        base, _, _, keys1 = arms["1x1"]
        for name, (reqs, rep, launches, _) in arms.items():
            paths[f"mesh {name} (phase 14)"] = launches
            if name == "1x1":
                continue
            ties = _mesh_equals(f"mesh {name}", cfg, params, base, reqs,
                                keys1)
            out.setdefault("ties", {})[name] = ties
            log(f"[mesh] {name}: tokens = 1x1's on {len(reqs) - ties} of "
                f"{len(reqs)} requests ({sum(not r.greedy for r in reqs)} "
                f"sampled, {sum(len(r.tokens) for r in reqs)} tokens), {ties}"
                f" near-tie divergences; {rep['steps']} steps, lanes "
                f"{rep['lane_steps']}, 0 captures after warmup; launches "
                + ", ".join(f"{k} {launches[k]}" for k in MESH_KERNELS))
        peak = torch.cuda.max_memory_allocated()
        pools = {m: _pool_bytes(eng, "fp32", m)
                 for m in ("1x1", "1x2", "2x1", "2x2")}
        weights = sum(t.numel() * t.element_size() for t in params.values())
        pieces = sum(t.numel() * t.element_size()
                     for t in eng._tp_pieces.values())
        reckoned = weights + pieces + sum(pools.values())
        errs = _mesh_step_logits(eng, cfg)
        timing = {m: _mesh_replay_ms(eng, m)
                  for m in ("1x1", "1x2", "2x1", "2x2")}
        t_wait = time.perf_counter()
        _finish_mesh_launcher(*launcher)
        t_wait = time.perf_counter() - t_wait
    del eng
    _release_engines()
    smoke = _mesh_smoke_card_vs_cpu()
    pc = _pipeline_and_collectives()
    out.update(seconds=time.perf_counter() - t0, paths=paths, errs=errs,
               timing=timing, peak_gb=peak / 1e9)
    log(f"[mesh] olmo-1b bf16 on four logical devices of one card "
        f"{MESH_ECFG['devices']}: {captures} targets captured for the "
        f"ladder 1x1 / 1x2 / 2x1 / 2x2 in {t_warm:.1f} s; the ladder arm "
        f"{r0['finished']} finished, 2 rebinds, 0 captures after warmup")
    log(f"[mesh] one step's logits against 1x1 (decode, prefill max abs): "
        + "; ".join(f"{m} {e[0]:.4f}, {e[1]:.4f}" for m, e in errs.items())
        + f" (limit {STEP_LOGIT_ATOL})")
    for m, t in timing.items():
        log(f"[mesh] replayed cbp step at {m} (8 slots at position 200, "
            f"16-page tables): wall {t['wall_ms']:.4f} ms, device busy "
            f"{_fmt_ms(t['busy_ms'])} by {t['by']} | {_card()}")
    log(f"[mesh] peak {peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} GB "
        f"reckoned (weights {weights / 1e9:.3f} + the split weights' pieces "
        f"{pieces / 1e9:.3f} + four pools "
        + ", ".join(f"{m} {b / 1e9:.3f}" for m, b in pools.items())
        + f" GB) | {_card()}")
    log(f"[mesh] smoke (fp32) card = CPU at 1x2 and 2x2 ({smoke} tokens); "
        f"pipeline_forward over 4 logical stages = reference_forward, max "
        f"abs err {pc['pipeline_err']:.3g} (bubble "
        f"{pc['bubble']:.4f}); compressed_psum card = CPU")
    log(f"[mesh] phase 14 passed in {out['seconds']:.1f}s (of which "
        f"{t_wait:.1f}s waiting for the launcher) | {_card()}")
    return out

# ---- phase 15 (every lane of both continuous engines on those meshes)
# olmo-1b at full width (bf16), 8 slots, page 16, chunk 64, max_len 1024,
# four logical devices that all name this card and the ladder 1x1 / 1x2 /
# 2x2: phase 3's int8+spec cell (an int8 pool, spec k up to 4, a 2-layer
# int8 draft) on a paged engine, then phase 3c's dense cells (a) cb+pfd and
# (b) with speculation on one dense engine (cell (a)'s batcher does not
# speculate), every target a CUDA graph.
LANES_ECFG = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64,
                  spec_k=4, draft_layers=2, draft_kv_dtype="int8",
                  mesh="1x1", meshes=("1x2", "2x2"),
                  devices=("cuda:0",) * 4)
LANES_CELLS = {  # cell: (engine, the engine's pool dtype, speculation)
    "paged int8+spec": ("paged", "int8", None),
    "dense a: cb+pfd": ("dense", "fp32", False),
    "dense b: spec int8 draft": ("dense", "fp32", None),
}
LANES_SMOKE = {  # the fp32 smoke config's cells, card = CPU
    "paged": dict(kv_dtype="int8", spec_k=2, draft_kv_dtype="int8"),
    "dense": dict(spec_k=2),
}
# ... at 1x2 and 2x2, and at 1x4, where the smoke config's 2 kv heads stay
# whole: the pool is replicated over "model" and the dense caches split
# their sequence (olmo-1b's 16 kv heads divide at every mesh here)
LANES_SMOKE_MESHES = ("1x2", "2x2", "1x4")


def _cache_bytes(eng) -> dict:
    """The bytes of every pool, dense and draft cache the engine holds,
    by kind (a mesh's pieces each counted: replicas are allocations)."""
    out = {}
    for kind, caches in (("pools", eng._paged_caches),
                         ("dense", eng._dense_caches),
                         ("drafts", eng._draft_caches)):
        out[kind] = sum(t.numel() * t.element_size() for c in
                        caches.values() for layer in c for t in layer.values())
    return out


def _lanes_cell(eng, cfg, params, cell: str, rebinds0: int) -> dict:
    """One cell at 1x1, 1x2 and 2x2 and on the ladder 1x2 -> 2x2 -> 1x1
    (the flips at a quarter and a half of 1x1's steps), each arm its own
    path (``_mesh_arm``): 0 captures after warmup, launches = the
    replays' reckoning, the speculative lanes stepped, tokens = 1x1's but
    for near-ties, 2 rebinds on the ladder."""
    engine, kv, spec = LANES_CELLS[cell]
    traffic = (_shared_prefix_traffic if engine == "paged"
               else partial(_continuous_traffic, prompt_len=128))
    kw = dict(engine=engine, spec=spec)
    arms = {}
    for mesh in ("1x1", "1x2", "2x2"):
        arms[mesh] = _mesh_arm(eng, cfg, f"lanes {cell} {mesh}", mesh,
                               reqs=traffic(cfg), **kw)
    n = arms["1x1"][1]["steps"]
    arms["ladder"] = _mesh_arm(
        eng, cfg, f"lanes {cell} ladder 1x2 -> 2x2 -> 1x1", "1x2",
        flips={n // 4: "2x2", n // 2: "1x1"}, reqs=traffic(cfg), **kw)
    rebinds = int(eng.telemetry.registry.value("mesh_rebinds_total"))
    check(rebinds - rebinds0 == 2, f"lanes {cell} ladder: "
          f"{rebinds - rebinds0} rebinds")
    base, _, _, keys1 = arms["1x1"]
    out = {"paths": {}, "ties": {}, "steps": n, "rebinds": rebinds}
    for name, (reqs, rep, launches, _) in arms.items():
        out["paths"][f"lanes {cell} {name} (phase 15)"] = launches
        spec_on = rep["lane_steps"].get("verify", 0) > 0
        check(spec_on == (spec is not False), f"lanes {cell} {name}: lane "
              f"steps {rep['lane_steps']}")
        if name == "1x1":
            continue
        ties = _mesh_equals(f"lanes {cell} {name}", cfg, params, base, reqs,
                            keys1, kv)
        out["ties"][name] = ties
        log(f"[lanes] {cell} {name}: tokens = 1x1's on {len(reqs) - ties} "
            f"of {len(reqs)} requests ({sum(not r.greedy for r in reqs)} "
            f"sampled, {sum(len(r.tokens) for r in reqs)} tokens), {ties} "
            f"near-tie divergences; {rep['steps']} steps, lanes "
            f"{rep['lane_steps']}, 0 captures after warmup; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return out


def _lanes_replays(eng, engine: str) -> dict:
    """Replayed steps at 1x1, 1x2 and 2x2 (8 slots at position 200): the
    paged engine's ``cbp`` over the int8 pool (16-page tables) and its
    ``vf`` at k 4 (a 5-row window), the dense engine's ``cb``; wall and
    busy ms per step (``_replay_ms``)."""
    from repro_torch.core import lanes

    i32, dev = torch.int32, "cuda"
    out = {}
    for mesh in ("1x1", "1x2", "2x2"):
        if engine == "dense":
            out["cb", mesh] = _replay_ms(_dense_cb_run(eng, 8, mesh))
            continue
        pool = eng.paged_cache("int8", mesh)
        exe = eng._decode.build(lanes.CBP.key(8, 16, "int8", mesh))
        state = _steady_args(exe, [
            torch.zeros(8, 1, dtype=i32, device=dev),
            torch.full((8,), 200, dtype=i32, device=dev), _mesh_tables(eng),
            torch.ones(8, dtype=torch.bool, device=dev),
            torch.ones(8, device=dev),
            torch.ones(8, dtype=torch.bool, device=dev), _row_keys(8)])

        def cbp(exe=exe, state=state, pool=pool):
            o = exe(pool, *state)
            state[0], state[1], state[6] = o[4], o[2], o[3]
            return o[5].cpu()

        out["cbp int8", mesh] = _replay_ms(cbp)
        exe = eng._decode.build(lanes.VF.key(8, 4, "int8", mesh))
        args = _steady_args(exe, [
            torch.zeros(8, 5, dtype=i32, device=dev),
            torch.full((8,), 200, dtype=i32, device=dev),
            _mesh_tables(eng, pages=eng.max_pages_per_req),
            torch.full((8,), 5, dtype=i32, device=dev),
            torch.ones(8, device=dev),
            torch.ones(8, dtype=torch.bool, device=dev), _row_keys(8)])
        out["vf int8 k 4", mesh] = _replay_ms(
            lambda exe=exe, args=args, pool=pool: exe(pool, *args)[4].cpu())
    return out


def lanes_phase(cfg, params) -> dict:
    """Phase 15: every lane of both continuous engines on meshes of more
    than one logical device of this card (ROADMAP A12 part 3, items 1-2;
    olmo-1b on its first ``OLMO_CUT_LAYERS`` layers):
    ``_lanes_cell`` for each cell, the replayed steps, the peak against
    the reckoned bytes per engine, and the smoke config card = CPU on both
    engines at ``LANES_SMOKE_MESHES``."""
    from repro_torch.runtime.serve import Engine, EngineConfig

    _release_engines()
    t0 = time.perf_counter()
    cfg, params = _depth_view(cfg, params, OLMO_CUT_LAYERS, "lanes")
    weights = sum(t.numel() * t.element_size() for t in params.values())
    out = {"paths": {}, "ties": {}, "timing": {}, "peak": {}, "warm": {},
           "arms_s": {}}
    for engine, cells, extra in (
            ("paged", ["paged int8+spec"], dict(kv_dtype="int8")),
            ("dense", ["dense a: cb+pfd", "dense b: spec int8 draft"], {})):
        torch.cuda.reset_peak_memory_stats()
        with Engine(cfg, params, EngineConfig(**LANES_ECFG, **extra)) as eng:
            check(eng.graphs, "lanes: the engine's targets are not CUDA "
                  "graphs")
            for cell in cells:
                spec = LANES_CELLS[cell][2]
                t_warm = time.perf_counter()
                captured = eng._decode.stats.misses
                if engine == "paged":  # captures every mesh's targets
                    eng.paged_continuous(slots=8)
                else:
                    eng.continuous(slots=8, spec_decode=spec)
                out["warm"][cell] = (eng._decode.stats.misses - captured,
                                     time.perf_counter() - t_warm)
                rebinds0 = int(eng.telemetry.registry.value(
                    "mesh_rebinds_total"))
                t_arms = time.perf_counter()
                got = _lanes_cell(eng, cfg, params, cell, rebinds0)
                out["arms_s"][cell] = time.perf_counter() - t_arms
                out["paths"].update(got["paths"])
                out["ties"][cell] = got["ties"]
            out["timing"].update(_lanes_replays(eng, engine))
            peak = torch.cuda.max_memory_allocated()
            caches = _cache_bytes(eng)
            pieces = sum(t.numel() * t.element_size()
                         for t in eng._tp_pieces.values())
            reckoned = weights + pieces + sum(caches.values())
            total = torch.cuda.get_device_properties(0).total_memory
            check(reckoned <= peak <= total, f"lanes {engine}: peak "
                  f"{peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} GB "
                  f"reckoned, {total / 1e9:.2f} GB on the card")
            out["peak"][engine] = (peak, reckoned, weights, pieces, caches)
        del eng
        _release_engines()
    smoke = {engine: _mesh_smoke_card_vs_cpu(cell, engine,
                                             LANES_SMOKE_MESHES)
             for engine, cell in LANES_SMOKE.items()}
    out["seconds"] = time.perf_counter() - t0
    for cell, (n, sec) in out["warm"].items():
        log(f"[lanes] {cell}: {n} targets captured over 1x1 / 1x2 / 2x2 in "
            f"{sec:.1f} s; its four arms {out['arms_s'][cell]:.1f} s")
    for (lane, mesh), t in out["timing"].items():
        log(f"[lanes] replayed {lane} step at {mesh} (8 slots at position "
            f"200): wall {t['wall_ms']:.4f} ms, device busy "
            f"{_fmt_ms(t['busy_ms'])} by {t['by']} | {_card()}")
    for engine, (peak, reckoned, w, pieces, caches) in out["peak"].items():
        log(f"[lanes] {engine} engine: peak {peak / 1e9:.2f} GB against "
            f"{reckoned / 1e9:.2f} GB reckoned (weights {w / 1e9:.3f} + the "
            f"split weights' pieces {pieces / 1e9:.3f} + "
            + ", ".join(f"{k} {b / 1e9:.3f}" for k, b in caches.items())
            + f" GB over the three meshes) | {_card()}")
    log(f"[lanes] smoke (fp32) card = CPU at {', '.join(LANES_SMOKE_MESHES)}"
        f" (1x4: the dense caches' sequence split): the int8 paged stream "
        f"with spec {smoke['paged']} tokens, the dense stream with spec "
        f"{smoke['dense']} tokens")
    log(f"[lanes] phase 15 passed in {out['seconds']:.1f}s | {_card()}")
    return out


# ------ phase 16 (disaggregation over multi-device slices, overload on a
# plan, the capture report of a multi-device key)
# olmo-1b at full width (bf16), 8 slots, page 16, chunk 64, max_len 1024,
# four logical devices that all name this card: DisaggPlan.split("2x2")
# (decode "1x2", prefill "1x2@2") on bf16 and int8 pools, sync and async,
# with the capture report on the bf16 engine; split("3x1") (decode "2x1",
# prefill "1x1@2"); phase 13's mixed() stream through each, held to phase
# 13's one-device shared stream; then the overload stream at "1x2".
SPLIT_ECFG = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64,
                  devices=("cuda:0",) * 4)
SPLITS = {"2x2": ("1x2", "1x2@2"), "3x1": ("2x1", "1x1@2")}
OVERLOAD_PLAN_ECFG = dict(OVERLOAD_ECFG, mesh="1x2", devices=("cuda:0",) * 4)


def _split_arm(eng, cfg, params, label: str, slices: tuple, phase13: dict,
               kv: str, async_steps: bool) -> tuple:
    """One split stream (``_disagg_arm`` over ``slices``) held to phase
    13's one-device run of the same pool dtype and mode: tokens = its
    shared stream's but for near-ties (``_mesh_equals``), migrations and
    migrated pages = its split's. Returns (requests, tie count, report,
    launches, launches by slice)."""
    tag = f"{'bf16' if kv == 'fp32' else 'int8'} " \
          f"{'async' if async_steps else 'sync'}"
    reqs, rep, launches, by_slice = _disagg_arm(
        eng, cfg, label, slices=slices, disagg=slices[1],
        async_steps=async_steps)
    ties = _mesh_equals(label, cfg, params, phase13["shared"][tag], reqs, {},
                        kv)
    got = (rep["migrations"], rep["migrated_pages"])
    check(got == phase13["split"][tag], f"{label}: {got[0]} migrations of "
          f"{got[1]} pages, the one-device split (phase 13) "
          f"{phase13['split'][tag]}")
    check(rep["mesh"] == slices[0] and rep["disagg"], f"{label}: report "
          f"mesh {rep['mesh']}, disagg {rep['disagg']}")
    return reqs, ties, rep, launches, by_slice


def _split_capture(eng) -> dict:
    """Every warmed key's capture report at the split (no ``error``), and
    the decode slice's ``cbp`` key (8 slots, 16 pages): one device's flops,
    bytes and collective bytes by op type."""
    from repro_torch.core import lanes

    reps = {str(r["key"]): r for r in eng.telemetry.compile_reports}
    bad = [k for k, r in reps.items() if "error" in r]
    check(reps and not bad, f"split capture report: errors at {bad[:3]}")
    r = reps[str(lanes.CBP.key(8, 16, "fp32", "1x2"))]
    check(r["chips"] == 2 and r["collectives"].get("all-reduce", 0) > 0,
          f"split capture report cbp: chips {r['chips']}, collectives "
          f"{r['collectives']}")
    return {"keys": len(reps), "flops": r["flops"], "bytes": r["bytes"],
            "collectives": r["collectives"], "chips": r["chips"],
            "t_collective_s": r["roofline"]["t_collective_s"]}


def split_mesh_phase(cfg, params, phase13: dict) -> dict:
    """Phase 16: disaggregated prefill/decode over multi-device slices of
    this card (ROADMAP A12 part 3, item 3), the overload stream on a
    multi-device plan (item 8) and the capture report of a multi-device key
    (item 6's collective bytes). Each split stream is its own path (counts
    set to 0 just before, read just after, held to the replays per slice):
    0 captures after warmup, tokens = phase 13's one-device shared stream
    but near-ties, migrations and migrated pages = phase 13's split; at
    1x2 split -> collapse -> split (2 rebinds), one migration's ms and a
    replayed ``cbp`` step on the decode slice; the peak against the
    reckoned bytes. Then phase 11's inert arm and its flood (two arms,
    ``_flood_arms_equal``) at 1x2."""
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.runtime.serve import Engine, EngineConfig

    _release_engines()
    t0 = time.perf_counter()
    weights = sum(t.numel() * t.element_size() for t in params.values())
    out = {"paths": {}, "ties": {}, "peak": {}}
    for base, kv, modes in (("2x2", "fp32", (False, True)),
                            ("2x2", "int8", (False, True)),
                            ("3x1", "fp32", (False,))):
        dec, pf = SPLITS[base]
        tag = "bf16" if kv == "fp32" else "int8"
        torch.cuda.reset_peak_memory_stats()
        tel = Telemetry(compile_analysis=(base, kv) == ("2x2", "fp32"))
        t_warm = time.perf_counter()
        with Engine(cfg, params, EngineConfig(
                kv_dtype=kv, mesh=dec, meshes=(pf,), **SPLIT_ECFG),
                telemetry=tel) as eng:
            check(eng.graphs, "split: the engine's targets are not CUDA "
                  "graphs")
            eng.paged_continuous(slots=8, disagg=pf)  # captures both slices
            captures = eng._decode.stats.misses
            t_warm = time.perf_counter() - t_warm
            for async_steps in modes:
                mode = "async" if async_steps else "sync"
                label = f"split {dec}+{pf} {tag} {mode}"
                reqs, ties, rep, launches, by_slice = _split_arm(
                    eng, cfg, params, label, (dec, pf), phase13, kv,
                    async_steps)
                out["ties"][label] = ties
                out["paths"][f"{label} (phase 16)"] = launches
                log(f"[split] {label}: tokens = the one-device shared "
                    f"stream's on {len(reqs) - ties} of {len(reqs)} "
                    f"requests, {ties} near-tie divergences; "
                    f"{rep['migrations']} migrations of "
                    f"{rep['migrated_pages']} pages (= phase 13's), lanes "
                    f"{rep['lane_steps']}, 0 captures after warmup "
                    f"({captures} captured in {t_warm:.1f} s); launches per "
                    f"slice ({dec} / {pf}): "
                    + "; ".join(f"{k} {by_slice[dec].get(k, 0)} / "
                                f"{by_slice[pf].get(k, 0)}"
                                for k in sorted(launches) if launches[k])
                    + f" | {_card()}")
            if kv == "fp32" and base == "2x2":
                out["rebind"], split_cb = _disagg_rebind_arm(eng, cfg)
                out["rebind"].update(_time_transport(
                    split_cb, tag=f"split {dec}+{pf}"))
                del split_cb  # its batcher holds the engine's storage
                out["capture"] = _split_capture(eng)
                out["cbp"] = _mesh_replay_ms(eng, dec)
            ptrs = [{t.data_ptr() for d in eng.paged_cache(kv, m)
                     for t in d.values()} for m in (dec, pf)]
            check(not ptrs[0] & ptrs[1],
                  f"split {dec}+{pf} {tag}: the slices' pools share storage")
            pieces = sum(t.numel() * t.element_size()
                         for t in eng._tp_pieces.values())
            caches = _cache_bytes(eng)
            reckoned = weights + pieces + sum(caches.values())
            peak = torch.cuda.max_memory_allocated()
            total = torch.cuda.get_device_properties(0).total_memory
            check(reckoned <= peak <= total, f"split {dec}+{pf} {tag}: peak "
                  f"{peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} GB "
                  f"reckoned")
            out["peak"][f"{dec}+{pf} {tag}"] = (peak, reckoned, pieces,
                                                caches["pools"])
        del eng
        _release_engines()
    t_split = time.perf_counter() - t0
    t_over = time.perf_counter()
    inert = _overload_inert(cfg, params, OVERLOAD_PLAN_ECFG, modes=(False,),
                            tag="1x2")
    flood = _overload_flood(cfg, params, False, OVERLOAD_PLAN_ECFG, "1x2")
    traced = _overload_flood(cfg, params, True, OVERLOAD_PLAN_ECFG, "1x2")
    log(f"[overload:1x2:flood] plain arm against traced arm under the step "
        f"clock: {_flood_arms_equal(flood, traced)}")
    _release_engines()
    out["paths"]["overload 1x2 inert (phase 16)"] = inert["launches"]
    out["paths"]["overload 1x2 flood (phase 16)"] = flood["launches"]
    t_over = time.perf_counter() - t_over
    out["seconds"] = time.perf_counter() - t0
    rb, cap, cbp = out["rebind"], out["capture"], out["cbp"]
    log(f"[split] 1x2+1x2@2 split -> collapse -> split: {rb['rebinds']} "
        f"rebinds, {rb['migrations']} migrations of {rb['migrated_pages']} "
        f"pages, 0 captures after warmup; one migration of 30 pages "
        f"{rb['migration_ms']:.4f} ms (phase 13 at one device, this run: "
        f"{phase13['rebind']['migration_ms']:.4f} ms), "
        f"bound {rb['migration_bound_ms']:.4f} ms | {_card()}")
    log(f"[split:capture] {cap['keys']} keys, none an error; cbp (8 slots, "
        f"16 pages) at 1x2, one of {cap['chips']} devices: "
        f"{cap['flops'] / 1e9:.4f} GFLOP, {cap['bytes'] / 1e9:.4f} GB "
        f"counted, collectives "
        + ", ".join(f"{op} {n / 1e6:.4f} MB" for op, n in
                    cap["collectives"].items())
        + f" (collective term {cap['t_collective_s'] * 1e6:.3f} us at the "
        f"data sheet's 900 GB/s NVLink) | {_card()}")
    log(f"[split] replayed cbp step on the decode slice 1x2 (8 slots at "
        f"position 200, 16-page tables): wall {cbp['wall_ms']:.4f} ms, "
        f"device busy {_fmt_ms(cbp['busy_ms'])} by {cbp['by']} | {_card()}")
    for name, (peak, reckoned, pieces, pools) in out["peak"].items():
        log(f"[split] {name}: peak {peak / 1e9:.2f} GB against "
            f"{reckoned / 1e9:.2f} GB reckoned (weights {weights / 1e9:.3f} "
            f"+ the split weights' pieces {pieces / 1e9:.3f} + the two "
            f"slices' pools {pools / 1e9:.3f} GB) | {_card()}")
    log(f"[split] phase 16 passed in {out['seconds']:.1f}s (the splits "
        f"{t_split:.1f}s, the overload stream at 1x2 {t_over:.1f}s) | "
        f"{_card()}")
    return out


# ---- phase 18 (the MoE family on meshes of logical devices)
# granite-moe-1b-a400m at full width (bf16, 32 experts top-8, float32
# routers) on 4 of its 24 layers, phase 14's engine shape and the ladder
# 1x1 / 1x2 / 2x2 over four logical devices of this card, every target a
# CUDA graph; the MoE tail under "drop" (EP: 16 experts a shard at model 2).
MOE_MESH_LAYERS = 4
MOE_MESH_ECFG = dict(max_len=1024, max_batch=8, page_size=16, prefill_chunk=64,
                     mesh="1x1", meshes=("1x2", "2x2"),
                     devices=("cuda:0",) * 4, moe_policy="drop")
# phase 3's int8+spec cell, at 1x2 alone
MOE_MESH_INT8 = dict(MOE_MESH_ECFG, mesh="1x2", meshes=(), kv_dtype="int8",
                     kv_dtypes=("int8",), spec_k=4, draft_layers=2,
                     draft_kv_dtype="int8")
MOE_POLICIES = ("drop", "dense", "gather")
MOE_TRAIN_MESHES = ((1, 2), (2, 2))


def _moe_all_reduce_bytes(cfg, slots: int) -> int:
    """One device's all-reduce bytes of a ``cbp`` step at model size 2:
    the head's partial logits ``[S, V]`` at the model dtype (granite's
    49155-entry vocab splits the table's d_model), and per layer ``wo``'s
    ``[S, D]`` at the model dtype and the MoE tail's in float32."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    return slots * (cfg.vocab_size * el
                    + cfg.num_layers * cfg.d_model * (el + 4))


def _moe_mesh_arms(eng, cfg, params, tag: str, hold: bool) -> tuple:
    """The stream at 1x1, 1x2 and 2x2 on a warmed engine (``_mesh_arm``:
    launches held, 0 captures after warmup) -> (each arm's path, each
    mesh's divergences from 1x1: held to near-ties with ``hold``, else
    counted: the requests whose tokens differ)."""
    arms, paths, ties = {}, {}, {}
    for mesh in ("1x1", "1x2", "2x2"):
        arms[mesh] = _mesh_arm(eng, cfg, f"moe mesh {tag} {mesh}", mesh)
        paths[f"{GRANITE} {tag} mesh {mesh} (phase 18)"] = arms[mesh][2]
    base, _, _, keys1 = arms["1x1"]
    ties["1x1"] = 0
    for name in ("1x1", "1x2", "2x2"):
        reqs, rep, launches, _ = arms[name]
        if name == "1x1":
            pass
        elif hold:
            ties[name] = _mesh_equals(f"moe mesh {tag} {name}", cfg, params,
                                      base, reqs, keys1)
        else:
            ties[name] = sum(r.tokens != d.tokens
                             for r, d in zip(base, reqs))
        log(f"[moe-mesh] {tag} {name}: tokens = 1x1's on "
            f"{len(reqs) - ties[name]} of {len(reqs)} requests "
            f"({sum(not r.greedy for r in reqs)} sampled, "
            f"{sum(len(r.tokens) for r in reqs)} tokens), {ties[name]} "
            + ("near-tie divergences (held)" if hold else
               "divergences (logged, not held)")
            + f"; {rep['steps']} steps, lanes {rep['lane_steps']}, 0 "
            f"captures after warmup; launches "
            + ", ".join(f"{k} {launches[k]}" for k in MESH_KERNELS))
    return paths, ties


def _moe_mesh_train(cfg, params) -> dict:
    """The mesh train step on the phase's cut (bf16, remat "block", phase
    12's batch and optimizer): the one-device ``make_train_fn``'s first
    step, then 3 steps at each of ``MOE_TRAIN_MESHES`` (``cuda:0`` at every
    coordinate): the first loss, ``moe_aux`` and ``grad_norm`` within
    ``TRAIN_MESH_LOSS_RTOL`` of one device's, every step finite, replicas
    equal; no kernel launched."""
    from repro_torch import kernels
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    keys = ("loss", "moe_aux", "grad_norm")
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    kernels.reset_launch_counts()  # the path's run starts here
    one = _fresh_state(cfg, params={k: v.clone() for k, v in params.items()})
    fn, ms1 = steps.make_train_fn(cfg, opt), []
    for i in range(MESH_TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        one, m = fn(one, batch)
        end.record()
        end.synchronize()
        ms1.append(start.elapsed_time(end))
        if i == 0:
            want = {k: float(m[k]) for k in keys}
    del one, m
    _release_engines()
    shape = ShapeSpec("phase18", "train", TRAIN_SEQ, TRAIN_BATCH)
    out = {"one device": dict(first=want, ms=ms1,
                              step_ms=statistics.median(ms1[1:]))}
    log(f"[moe-mesh:train] {GRANITE} ({cfg.num_layers} layers) one device: "
        f"step 1 " + ", ".join(f"{k} {v:.6f}" for k, v in want.items())
        + f" | step ms (CUDA events) median {out['one device']['step_ms']:.3f}"
        f" of steps 2-{MESH_TRAIN_STEPS} (all: "
        + ", ".join(f"{x:.1f}" for x in ms1) + f") | {_card()}")
    for dp, mp in MOE_TRAIN_MESHES:
        name = f"{dp}x{mp}"
        mesh = make_debug_mesh((dp, mp))
        state = steps.place_train_state(cfg, _fresh_state(cfg, params=params),
                                        mesh)
        exe = steps.lower_for(cfg, mesh, shape, opt_cfg=opt).compile()
        ms, losses, first = [], [], None
        for i in range(MESH_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, m = exe(state, batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            check(_finite(m["loss"]) and _finite(m["grad_norm"]),
                  f"moe train mesh {name}: step {i + 1} loss {losses[-1]}")
            if i == 0:
                first = {k: float(m[k]) for k in keys}
                rel = {k: abs(first[k] - want[k]) / abs(want[k])
                       for k in keys}
                check(all(r <= TRAIN_MESH_LOSS_RTOL for r in rel.values()),
                      f"moe train mesh {name}: first step {first}, one "
                      f"device {want} (relative {rel}, limit "
                      f"{TRAIN_MESH_LOSS_RTOL})")
        replicated = _check_replicas(state)
        out[name] = dict(first=first, rel=rel, losses=losses, ms=ms,
                         step_ms=statistics.median(ms[1:]))
        log(f"[moe-mesh:train] {GRANITE} ({cfg.num_layers} layers, bf16, "
            f"remat {cfg.remat}) {name}: {TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"{MESH_TRAIN_STEPS} steps: losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + " | step 1 " + ", ".join(
                f"{k} {first[k]:.6f} (one device {want[k]:.6f}, relative "
                f"{rel[k]:.3g})" for k in keys)
            + f" | {replicated} replicated pieces equal bit for bit | step "
            f"ms (CUDA events) median {out[name]['step_ms']:.3f} of steps "
            f"2-{MESH_TRAIN_STEPS} (all: " + ", ".join(f"{x:.1f}" for x in ms)
            + f") | {_card()}")
        del state, exe, m
        _release_engines()
    out["launches"] = _launches("moe train mesh (phase 18)", ())
    del batch
    _release_engines()
    return out


def moe_mesh_phase() -> dict:
    """Phase 18: granite-moe on meshes of logical devices of this card
    (``MOE_MESH_ECFG``; module docstring). The bf16 cell's stream under
    "drop" at 1x1, 1x2 and 2x2 (0 captures after warmup, each kernel's
    launches = the replays' reckoning, tokens against 1x1's counted), and
    the same weights in fp32 (tokens = 1x1's but near-ties, held); one
    decode step's and one prefill chunk's logits per MoE policy at 1x2 and
    2x2 against 1x1 (bf16 logged, fp32 held to ``STEP_LOGIT_ATOL``): a
    bf16 rounding of a TP sum moves one of granite's random top-8 routing
    choices, and the logits after it by more than a near-tie (phase 9
    holds granite on fp32 weights for the same reason; on an H100 a 1x2
    greedy row left 1x1's at token 8 where the two logits were 0.4688
    apart); a replayed
    ``cbp`` step per mesh; the 1x2
    ``cbp`` key's capture report (its all-reduce bytes =
    ``_moe_all_reduce_bytes``); the peak against the reckoned bytes; the
    int8+spec cell at 1x2; the mesh train step at 1x2 and 2x2; the fp32
    smoke config card = CPU at 2x2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Engine, EngineConfig

    _release_engines()
    t0 = time.perf_counter()
    cfg = _depth_cut(get_config(GRANITE), MOE_MESH_LAYERS, "moe-mesh")
    params = _seeded(cfg, "moe-mesh")
    torch.cuda.reset_peak_memory_stats()
    out, paths, arms = {}, {}, {}
    with Engine(cfg, params, EngineConfig(**MOE_MESH_ECFG)) as eng:
        check(eng.graphs, "moe mesh: the engine's targets are not CUDA graphs")
        t_warm = time.perf_counter()
        eng.paged_continuous(slots=8)  # captures every mesh's targets
        t_warm = time.perf_counter() - t_warm
        captures = eng._decode.stats.misses
        got, out["diverged bf16"] = _moe_mesh_arms(eng, cfg, params, "bf16",
                                                   hold=False)
        paths.update(got)
        peak = torch.cuda.max_memory_allocated()
        pools = {m: _pool_bytes(eng, "fp32", m) for m in ("1x1", "1x2", "2x2")}
        weights = sum(t.numel() * t.element_size() for t in params.values())
        pieces = sum(t.numel() * t.element_size()
                     for t in eng._tp_pieces.values())
        reckoned = weights + pieces + sum(pools.values())
        check(peak <= reckoned + 4e9, f"moe mesh: peak {peak / 1e9:.2f} GB "
              f"over the reckoned {reckoned / 1e9:.2f} GB + 4 GB")
        bf16 = {pol: _mesh_step_logits(eng, cfg, pol, "moe mesh bf16",
                                       hold=False) for pol in MOE_POLICIES}
        timing = {m: _mesh_replay_ms(eng, m) for m in ("1x1", "1x2", "2x2")}
        # the capture report of one key: its target built once more with
        # the analysis on (a capture of its own, after every counted path)
        eng.telemetry.compile_analysis = True
        try:
            eng._build_paged_slot_decode(8, 16, "fp32", "1x2")
            cap = eng._capture_report()
        finally:
            eng.telemetry.compile_analysis = False
        want_ar = _moe_all_reduce_bytes(cfg, 8)
        check("error" not in cap and cap["chips"] == 2
              and cap["collectives"].get("all-reduce") == want_ar,
              f"moe mesh capture report cbp 1x2: chips {cap['chips']}, "
              f"collectives {cap['collectives']}, all-reduce reckoned "
              f"{want_ar}")
    del eng
    _release_engines()
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    with Engine(c32, p32, EngineConfig(**MOE_MESH_ECFG)) as eng:
        eng.paged_continuous(slots=8)
        got, out["ties fp32"] = _moe_mesh_arms(eng, c32, p32, "fp32",
                                               hold=True)
        paths.update(got)
        fp32 = {pol: _mesh_step_logits(eng, c32, pol, "moe mesh fp32")
                for pol in MOE_POLICIES}
    del eng, p32
    _release_engines()
    with Engine(cfg, params, EngineConfig(**MOE_MESH_INT8)) as eng:
        eng.paged_continuous(slots=8)
        reqs, rep, launches, _ = _mesh_arm(
            eng, cfg, "moe mesh int8+spec 1x2", "1x2", shards=1)
        check(rep["lane_steps"]["verify"] > 0 < rep["lane_steps"]["draft"],
              f"moe mesh int8+spec 1x2: lanes {rep['lane_steps']}")
        paths[f"{GRANITE} mesh int8+spec 1x2 (phase 18)"] = launches
        log(f"[moe-mesh] int8+spec 1x2: {rep['finished']} finished, "
            f"{rep['steps']} steps, lanes {rep['lane_steps']}, 0 captures "
            f"after warmup; launches " + ", ".join(
                f"{k} {n}" for k, n in launches.items() if n))
    del eng
    _release_engines()
    train = _moe_mesh_train(cfg, params)
    paths[f"{GRANITE} train mesh (phase 18)"] = train["launches"]
    del params
    _release_engines()
    smoke = _mesh_smoke_card_vs_cpu(meshes=("2x2",), arch=GRANITE)
    out.update(seconds=time.perf_counter() - t0, paths=paths, bf16=bf16,
               fp32=fp32, timing=timing, train=train, peak_gb=peak / 1e9,
               capture=dict(flops=cap["flops"], bytes=cap["bytes"],
                            collectives=cap["collectives"]))
    log(f"[moe-mesh] {GRANITE} bf16 ({cfg.num_layers} of 24 layers) on four "
        f"logical devices of one card: {captures} targets captured for "
        f"1x1 / 1x2 / 2x2 in {t_warm:.1f} s")
    for name, errs in (("bf16 (logged)", bf16), ("fp32 weights (held)",
                                                  fp32)):
        log(f"[moe-mesh] one step's logits against 1x1, {name} (decode, "
            f"prefill max abs; limit {STEP_LOGIT_ATOL}): " + "; ".join(
                f"{pol} " + ", ".join(f"{m} {e[0]:.4g}, {e[1]:.4g}"
                                      for m, e in errs[pol].items())
                for pol in MOE_POLICIES))
    for m, t in timing.items():
        log(f"[moe-mesh] replayed cbp step at {m} (8 slots at position 200, "
            f"16-page tables): wall {t['wall_ms']:.4f} ms, device busy "
            f"{_fmt_ms(t['busy_ms'])} by {t['by']} | {_card()}")
    log(f"[moe-mesh] capture report of the 1x2 cbp key (8 slots, 16 "
        f"pages): {cap['flops'] / 1e9:.4f} GFLOP, {cap['bytes'] / 1e9:.4f} "
        f"GB a device, collective bytes "
        + ", ".join(f"{op} {n:.0f}" for op, n in cap["collectives"].items())
        + f" (all-reduce reckoned {want_ar})")
    log(f"[moe-mesh] peak {peak / 1e9:.2f} GB against {reckoned / 1e9:.2f} "
        f"GB reckoned (weights {weights / 1e9:.3f} + the split weights' "
        f"pieces {pieces / 1e9:.3f} + three pools "
        + ", ".join(f"{m} {b / 1e9:.3f}" for m, b in pools.items())
        + f" GB) | {_card()}")
    log(f"[moe-mesh] smoke (fp32) card = CPU at 2x2 ({smoke['2x2']} tokens)")
    log(f"[moe-mesh] phase 18 passed in {out['seconds']:.1f}s | {_card()}")
    return out


# ------- phase 19 (context-parallel attention, the embeddings family)
# bf16 at full width on logical devices of this card; the mesh steps run
# the plain attention (``steps.lower_for``: the kernels refuse a gradient,
# and the JAX package's lowered steps reach no Pallas kernel), so no kernel
# launches on them. gemma2's paged cell (B1, B2, sample_rows) runs its
# kernels per shard.
FALLBACK_B, FALLBACK_S, FALLBACK_DECODE, FALLBACK_REPS = 8, 512, 2, 3
FALLBACK_CUTS = {"musicgen-medium": 4, "qwen3-14b": 2, "gemma2-27b": 2}
FALLBACK_ECFG = dict(max_len=1024, max_batch=8, page_size=16,
                     prefill_chunk=64, mesh="1x1", meshes=("1x2",),
                     devices=("cuda:0",) * 2)


def _timed_call(fn) -> tuple:
    """(``fn()``'s result, its milliseconds by CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _fallback_inputs(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    """Seeded numpy inputs on the card: tokens, or a stub frontend's
    embeddings ``[b, s, D]`` in the model dtype."""
    import numpy as np

    from repro_torch.models.layers import dtype_of

    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    return torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to("cuda", dtype_of(cfg))


def _mesh_pieces(cfg, params: dict, mesh) -> dict:
    """The weights as the mesh steps take them: each leaf's pieces by the
    full rules (``fsdp.state_specs``), each its own copy."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd

    p_spec, _ = fsdp.state_specs(cfg, params, mesh)
    return {k: shd.shard(t, p_spec[k], mesh) for k, t in params.items()}


def _fallback_prefill(cfg, params, meshes, tag: str, *, decode: bool,
                      report: tuple = ()) -> dict:
    """``lower_for`` prefill of ``FALLBACK_B`` x ``FALLBACK_S`` at each mesh
    of ``meshes`` with the fallback off and on, each its own path (the
    counts set to 0 before and read after: no kernel): last-token logits
    within ``STEP_LOGIT_ATOL`` of one device's ``models.prefill`` (naive)
    and of each other; with ``decode``, ``FALLBACK_DECODE`` decode steps on
    the emitted cache at its last positions (rewriting them) against one
    device's ``decode_step`` on its own cache; for the meshes in
    ``report``, the prefill's capture report (a device's flops and
    collective bytes). An arm's ms is the median of ``FALLBACK_REPS``
    prefill calls after the checked one."""
    from repro_torch import capture_analysis, kernels, models, perf
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import steps

    b, s = FALLBACK_B, FALLBACK_S
    inputs = _fallback_inputs(cfg, b, s, seed=19)
    nxt = [_fallback_inputs(cfg, b, 1, seed=20 + j)
           for j in range(FALLBACK_DECODE)]
    positions = range(s - FALLBACK_DECODE, s)
    with torch.no_grad():
        want, cache1 = models.prefill(cfg, params, inputs, impl="naive")
        want_dec = [models.decode_step(
            cfg, params, cache1, x, torch.tensor(p, dtype=torch.int32,
                                                 device="cuda"),
            attn_impl="plain")[0] for x, p in zip(nxt, positions)] \
            if decode else []
    del cache1
    out = {}
    for dims in meshes:
        mesh = make_debug_mesh(dims)
        name = f"{dims[0]}x{dims[1]}"
        pieces = _mesh_pieces(cfg, params, mesh)
        got = {}
        for fb in (False, True):
            arm = f"{tag} {name} fallback {'on' if fb else 'off'}"
            opts = perf.PerfOpts(seq_shard_fallback=fb)
            low = steps.lower_for(cfg, mesh, ShapeSpec("p19", "prefill", s, b),
                                  opts=opts)
            step = low.compile()
            kernels.reset_launch_counts()  # this arm's path starts here
            logits, cache = step(pieces, inputs)
            ms = statistics.median(
                _timed_call(lambda: step(pieces, inputs))[1]
                for _ in range(FALLBACK_REPS))
            _launches(f"{arm} prefill", ())
            err = (logits - want).abs().max().item()
            check(_finite(logits) and logits.shape == want.shape
                  and err <= STEP_LOGIT_ATOL,
                  f"{arm}: prefill logits {tuple(logits.shape)} max abs "
                  f"{err:.4g} from one device's (limit {STEP_LOGIT_ATOL})")
            rec = dict(ms=ms, err=err, logits=logits)
            if decode:
                dec = steps.lower_for(
                    cfg, mesh, ShapeSpec("d19", "decode", s, b),
                    opts=opts).compile()
                errs, dms = [], []
                for x, p, w in zip(nxt, positions, want_dec):
                    (dl, _), t = _timed_call(lambda: dec(
                        pieces, cache, x, torch.tensor(p, dtype=torch.int32)))
                    errs.append((dl - w).abs().max().item())
                    dms.append(t)
                    check(_finite(dl) and errs[-1] <= STEP_LOGIT_ATOL,
                          f"{arm}: decode at {p} max abs {errs[-1]:.4g} from "
                          f"one device's (limit {STEP_LOGIT_ATOL})")
                _launches(f"{arm} decode", ())
                rec.update(decode_err=errs, decode_ms=dms)
            if dims in report:
                rep = capture_analysis.analyze_step(
                    step, (pieces, inputs), mesh=mesh,
                    arg_specs=low.arg_specs)
                rec.update(flops=rep["flops"],
                           collectives=dict(rep["collectives"]))
            del cache
            got[fb] = rec
            log(f"[fallback] {arm}: prefill {b} x {s} {ms:.3f} ms (CUDA "
                f"events, median of {FALLBACK_REPS}), logits max abs "
                f"{err:.4g} from one device's"
                + (f"; decode at {list(positions)} "
                   + ", ".join(f"{t:.3f} ms" for t in rec["decode_ms"])
                   + ", max abs " + ", ".join(
                       f"{e:.4g}" for e in rec["decode_err"])
                   if decode else "")
                + (f"; capture report {rec['flops'] / 1e9:.4f} GFLOP a "
                   f"device, collectives " + ", ".join(
                       f"{op} {n:.0f} B" for op, n in
                       rec["collectives"].items())
                   if "flops" in rec else "") + f" | {_card()}")
        gap = (got[True]["logits"] - got[False]["logits"]).abs().max().item()
        check(gap <= STEP_LOGIT_ATOL, f"{tag} {name}: fallback on vs off "
              f"logits max abs {gap:.4g} (limit {STEP_LOGIT_ATOL})")
        for rec in got.values():
            del rec["logits"]
        out[name] = dict(off=got[False], on=got[True], on_vs_off=gap)
        del pieces
        _release_engines()
    return out


def _fallback_train(cfg, params, dims: tuple, tag: str) -> dict:
    """Two train steps at ``dims`` with the fallback off and on (phase
    12's batch shape and ``TRAIN_OPT``), each its own path (no kernel):
    the first loss and ``grad_norm`` within ``TRAIN_MESH_LOSS_RTOL`` of
    one device's ``make_train_fn``; the ms of each second step."""
    from repro_torch import kernels, perf
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    keys = ("loss", "grad_norm")
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    batch = _device_batch(cfg, FALLBACK_B, FALLBACK_S)
    one = _fresh_state(cfg, params={k: v.clone() for k, v in params.items()})
    fn = steps.make_train_fn(cfg, opt)
    one, m = fn(one, batch)
    want = {k: float(m[k]) for k in keys}
    (one, _), ms1 = _timed_call(lambda: fn(one, batch))
    del one, m
    _release_engines()
    mesh = make_debug_mesh(dims)
    name = f"{dims[0]}x{dims[1]}"
    shape = ShapeSpec("t19", "train", FALLBACK_S, FALLBACK_B)
    out = {"one device": dict(first=want, ms=ms1)}
    for fb in (False, True):
        arm = f"{tag} train {name} fallback {'on' if fb else 'off'}"
        state = steps.place_train_state(cfg, _fresh_state(cfg, params=params),
                                        mesh)
        exe = steps.lower_for(cfg, mesh, shape, opt_cfg=opt,
                              opts=perf.PerfOpts(seq_shard_fallback=fb)
                              ).compile()
        kernels.reset_launch_counts()  # this arm's path starts here
        state, m = exe(state, batch)
        first = {k: float(m[k]) for k in keys}
        (state, _), ms = _timed_call(lambda: exe(state, batch))
        _launches(arm, ())
        rel = {k: abs(first[k] - want[k]) / abs(want[k]) for k in keys}
        check(all(_finite(m[k]) for k in keys)
              and all(r <= TRAIN_MESH_LOSS_RTOL for r in rel.values()),
              f"{arm}: first step {first}, one device {want} (relative "
              f"{rel}, limit {TRAIN_MESH_LOSS_RTOL})")
        out["on" if fb else "off"] = dict(first=first, rel=rel, ms=ms)
        log(f"[fallback] {arm}: {FALLBACK_B} x {FALLBACK_S}, step 1 "
            + ", ".join(f"{k} {first[k]:.6f} (one device {want[k]:.6f}, "
                        f"relative {rel[k]:.3g})" for k in keys)
            + f"; step 2 {ms:.3f} ms (one device {ms1:.3f} ms; CUDA events) "
            f"| {_card()}")
        del state, exe, m
        _release_engines()
    del batch
    _release_engines()
    return out


def _fallback_gemma2(tag: str) -> tuple:
    """gemma2-27b's cut through the paged engine (bf16 pages) at 1x1 and
    1x2 (``_mesh_arm``: launches = the replays' reckoning, 0 captures after
    warmup): 1x2's tokens = 1x1's but near-ties; B1/B2 per mode (every
    replay launches one per layer per shard: the local layers' window +
    softcap instantiation, the global layers' softcap one)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Engine, EngineConfig

    cfg = _depth_cut(get_config("gemma2-27b"), FALLBACK_CUTS["gemma2-27b"],
                     tag)
    params = _seeded(cfg, tag)
    local = sum(cfg.mixer_at(i % cfg.period) == "attn_local"
                for i in range(cfg.num_layers))
    arms = {}
    with Engine(cfg, params, EngineConfig(**FALLBACK_ECFG)) as eng:
        check(eng.graphs, "gemma2 mesh: the engine's targets are not graphs")
        eng.paged_continuous(slots=8)
        for mesh in ("1x1", "1x2"):
            arms[mesh] = _mesh_arm(eng, cfg, f"{tag} gemma2 {mesh}", mesh,
                                   shards=1)
    base, got = arms["1x1"][0], arms["1x2"][0]
    ties = _mesh_equals(f"{tag} gemma2 1x2", cfg, params, base, got,
                        arms["1x1"][3])
    per_mode = {}
    for mesh, (_, rep, launches, _) in arms.items():
        for k in ("paged_decode_attention", "paged_prefill_attention"):
            per = launches[k] * local // cfg.num_layers
            per_mode[mesh, k] = {"window+softcap": per,
                                 "softcap": launches[k] - per}
        log(f"[fallback] {tag} gemma2 {mesh}: {rep['finished']} finished, "
            f"{rep['steps']} steps, lanes {rep['lane_steps']}, 0 captures "
            f"after warmup; launches " + ", ".join(
                f"{k} {n}" for k, n in launches.items() if n)
            + "; per mode (all shards) " + "; ".join(
                f"{k}: " + ", ".join(f"{mode} {n}" for mode, n in
                                     per_mode[mesh, k].items())
                for k in ("paged_decode_attention",
                          "paged_prefill_attention")))
    log(f"[fallback] {tag} gemma2 1x2: tokens = 1x1's on "
        f"{len(got) - ties} of {len(got)} requests, {ties} near-tie "
        f"divergences")
    paths = {f"gemma2-27b mesh {m} (phase 19)": a[2] for m, a in arms.items()}
    del params
    _release_engines()
    return paths, ties, per_mode


def fallback_mesh_phase() -> dict:
    """Phase 19: context-parallel attention (``perf.seq_shard_fallback``)
    and the embeddings-input family on logical devices of this card, bf16
    (module docstring). internvl2-1b at full width and depth at 1x4 (14
    heads, 2 kv heads: neither divides 4) and 1x2 (both divide): prefill
    off/on against one device's, 2 decode steps, the 1x4 prefill's capture
    report off against on, one train step at 1x4 off/on against one
    device's; musicgen-medium's cut at 2x2 (the vocab split): prefill and
    train the same; qwen3-14b's cut at 1x16 (40 heads): prefill off/on;
    gemma2-27b's cut at 1x2 through the paged engine."""
    from repro_torch.configs import get_config

    _release_engines()
    t0 = time.perf_counter()
    tag = "fallback"
    out, paths = {}, {}
    cfg = get_config("internvl2-1b")
    params = _seeded(cfg, tag)
    out["internvl2-1b"] = dict(
        prefill=_fallback_prefill(cfg, params, ((1, 4), (1, 2)),
                                  "internvl2-1b", decode=True,
                                  report=((1, 4),)),
        train=_fallback_train(cfg, params, (1, 4), "internvl2-1b"))
    del params
    cfg = _depth_cut(get_config("musicgen-medium"),
                     FALLBACK_CUTS["musicgen-medium"], tag)
    params = _seeded(cfg, tag)
    out["musicgen-medium"] = dict(
        prefill=_fallback_prefill(cfg, params, ((2, 2),), "musicgen-medium",
                                  decode=False),
        train=_fallback_train(cfg, params, (2, 2), "musicgen-medium"))
    del params
    cfg = _depth_cut(get_config("qwen3-14b"), FALLBACK_CUTS["qwen3-14b"],
                     tag)
    params = _seeded(cfg, tag)
    out["qwen3-14b"] = dict(prefill=_fallback_prefill(
        cfg, params, ((1, 16),), "qwen3-14b", decode=False))
    del params
    _release_engines()
    got, ties, per_mode = _fallback_gemma2(tag)
    paths.update(got)
    rep = out["internvl2-1b"]["prefill"]["1x4"]
    log(f"[fallback] internvl2-1b 1x4 prefill capture report, off -> on: "
        f"{rep['off']['flops'] / 1e12:.4f} -> {rep['on']['flops'] / 1e12:.4f}"
        f" TFLOP a device, all-gather "
        f"{rep['off']['collectives'].get('all-gather', 0) / 1e6:.3f} -> "
        f"{rep['on']['collectives'].get('all-gather', 0) / 1e6:.3f} MB, "
        f"all-reduce "
        f"{rep['off']['collectives'].get('all-reduce', 0) / 1e6:.3f} -> "
        f"{rep['on']['collectives'].get('all-reduce', 0) / 1e6:.3f} MB")
    out.update(seconds=time.perf_counter() - t0, paths=paths,
               gemma2_ties=ties,
               gemma2_per_mode={f"{m} {k}": v for (m, k), v in
                                per_mode.items()})
    log(f"[fallback] phase 19 passed in {out['seconds']:.1f}s | {_card()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    spans, last = {}, [t0]

    def span(name: str) -> None:  # the seconds since the previous span
        now = time.perf_counter()
        spans[name] = now - last[0]
        last[0] = now

    setup()
    # what is alive now (torch, the port, the kernels' libraries) lives to
    # the end: out of the collector's sight, each _release_engines' full
    # collection walks only what the phases make
    gc.freeze()
    span("setup (the kernels' build)")
    kernels_vs_plain()
    sampling_vs_plain()
    span("kernels and sampling vs plain")
    main_path = full_width_streams()
    graph_phase(main_path["cfg"], main_path["params"])
    dense = continuous_phase(main_path["cfg"], main_path["params"],
                             main_path["burst_report"])
    span("olmo-1b streams, graphs, dense cells")
    main_path["by_path"].update({f"continuous {k}": v["launches"]
                                 for k, v in dense.items() if "launches" in v})
    t_async = time.perf_counter()
    async_phase(main_path["cfg"], main_path["params"])
    t_async = time.perf_counter() - t_async
    overload = overload_phase(main_path["cfg"], main_path["params"])
    t_c13, c13_launches = c13_on_card(main_path["cfg"], main_path["params"])
    disagg = disagg_phase(main_path["cfg"], main_path["params"])
    mesh = mesh_phase(main_path["cfg"], main_path["params"])
    lanes = lanes_phase(main_path["cfg"], main_path["params"])
    split = split_mesh_phase(main_path["cfg"], main_path["params"], disagg)
    span("phases 3d, 11 and 13-16")
    steps_kernel_vs_plain(main_path["cfg"], main_path["params"])
    prompt = prompt_then_burst(main_path["cfg"], main_path["params"])
    profile_steps(main_path["cfg"], main_path["params"])
    del main_path["params"]
    torch.cuda.empty_cache()
    ssd_vs_plain()
    mamba = mamba_full_width()
    torch.cuda.empty_cache()
    span("olmo-1b steps and prompt+burst, profiles, B8, mamba2")
    b2_verify = smoke_card_vs_cpu()
    continuous_smoke_card_vs_cpu()
    mamba_smoke_card_vs_cpu()
    span("smoke configs card vs CPU")
    launches = dict(main_path["launches"],
                    flash_attention=prompt["flash_attention"],
                    flash_attention_branchy=kernel_pair()[
                        "flash_attention_branchy"],
                    ssd_chunk=mamba["ssd_chunk"])
    rows = (time_kernels(launches, b2_verify, main_path["by_path"])
            + time_dense_kernels(launches)
            + time_ssd_kernel(launches)
            + time_sampling(main_path["launches"], main_path["by_path"]))
    span("kernel timings")
    t8 = time.perf_counter()
    paths = configs_phase()
    t9 = time.perf_counter()
    granite = granite_phase()
    smoke_card_vs_cpu_of(GRANITE, "granite")
    t9 = time.perf_counter() - t9
    paths.update(granite["paths"])
    t10 = time.perf_counter()
    paths.update(families_phase())
    t10 = time.perf_counter() - t10
    new = time_new_shapes()
    train = train_phase()
    t12 = t_c13 + train["seconds"]
    log(f"[train] phase 12 passed in {t12:.1f}s (C13 {t_c13:.1f}s, training "
        f"{train['seconds']:.1f}s) | {_card()}")
    train_mesh = train_mesh_phase()
    moe_mesh = moe_mesh_phase()
    paths.update(moe_mesh["paths"])
    fallback = fallback_mesh_phase()
    paths.update(fallback["paths"])
    paths["c13 two batchers (phase 12)"] = c13_launches
    paths.update({f"{k} (phase 13)": v for k, v in disagg["paths"].items()})
    paths.update(mesh["paths"])
    paths.update(lanes["paths"])
    paths.update(split["paths"])
    paths["train (phase 12)"] = train["launches"]
    paths["train mesh (phase 17)"] = train_mesh["launches"]
    for row in rows:
        if row["name"] in new:
            row["new_shapes"] = new[row["name"]]
        row.setdefault("launches_by_path", {}).update(
            {path: counts.get(row["name"], 0)
             for path, counts in paths.items()})
        if row["name"] in OVERLOAD_KERNELS:
            row["launches_by_path"].update(
                {path: counts[row["name"]]
                 for path, counts in overload["paths"].items()})
    end = time.perf_counter()
    log(f"[done] all phases passed in {end - t0:.1f}s; phases 8-10 "
        f"(three configs, granite-moe, the last five archs, new-shape "
        f"timing) {end - t8:.1f}s, {100 * (end - t8) / (end - t0):.1f}% of "
        f"it, of which phase 9 (granite-moe at full width and its smoke card "
        f"= CPU) {t9:.1f}s and phase 10 (deepseek-67b, grok-1-314b, jamba, "
        f"internvl2-1b, musicgen-medium) {t10:.1f}s; phase 3d (async vs "
        f"sync) {t_async:.1f}s; phase 11 (the overload stream) "
        f"{overload['seconds']:.1f}s; phase 12 (C13, training) {t12:.1f}s; "
        f"phase 13 (mesh, disagg, capture report) {disagg['seconds']:.1f}s; "
        f"phase 14 (meshes of more than one device) {mesh['seconds']:.1f}s; "
        f"phase 15 (every lane on those meshes) {lanes['seconds']:.1f}s; "
        f"phase 16 (splits over meshes, overload on a plan) "
        f"{split['seconds']:.1f}s; phase 17 (training on meshes) "
        f"{train_mesh['seconds']:.1f}s; phase 18 (granite-moe on meshes) "
        f"{moe_mesh['seconds']:.1f}s; phase 19 (context-parallel attention, "
        f"the embeddings family on meshes) {fallback['seconds']:.1f}s; "
        f"before phase 8: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in spans.items()))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
