"""Multi-pod dry run over ``meta`` meshes: build and count every (arch ×
shape × mesh) cell (the port's counterpart of ``repro.launch.dryrun``,
ROADMAP A12 part 3 item 5).

The production mesh (``launch.mesh.make_production_mesh``) is 256 (16 x 16)
or 512 (2 x 16 x 16) ``meta`` devices: nothing is allocated and no card is
touched. Per cell the record holds what the roofline needs:

* ``lower_s`` — building the step for the mesh's static shapes
  (``steps.lower_for``: the sharded abstract state, params, cache and
  batch on ``meta``);
* ``compile_s`` — the counting run: the step run once on those arguments
  under ``capture_analysis.analyze_step``. The port has no compiler, so
  this run is where the JAX package compiles;
* ``flops_per_device``, ``bytes_per_device``,
  ``collective_bytes_per_device`` (by the JAX package's op types) and
  ``mem`` — one device's, by ``capture_analysis``'s conventions (its
  module docstring: every op of the unfused eager step counts its inputs
  and outputs, so the bytes are not XLA's fusion-boundary bytes, and
  ``mem`` is not XLA's buffer assignment);
* ``unknown_trip_whiles`` — 0: Python loops run unrolled;
* ``xla_reported`` — equal to the counted values: the JAX package keeps
  there XLA's own ``cost_analysis()``, which counts a ``while`` body once,
  and the port counts every op as it runs, so there is no second count;
* analytic ``params_*``, ``tokens``, ``model_flops`` (6·N·D train,
  2·N_active·tokens inference) and ``min_bytes_global``, as the JAX
  package reckons them;
* ``roofline`` — ``roofline.roofline_terms`` at the H100 constants (the
  config's dtype's peak, HBM, NVLink).

Dense and MoE attention stacks run, on token or embeddings inputs (the MoE
tail under ``--moe-policy``, its experts over ``model`` where the rules put
them, ZeRO over ``pod`` on the multi-pod mesh for grok). A family the mesh
steps refuse (``tensor_parallel.check_family``: SSM, hybrid) gives an
``error`` record whose ``NotImplementedError`` names ROADMAP A12 part 3.
``--moe-hints`` and ``--moe-weight-gather`` are accepted and change no
number: the port's MoE tail already has the layout each asks GSPMD for
(``perf``). ``--seq-fallback`` sets ``perf.seq_shard_fallback`` (written
into the record's ``perf_opts``): where ``model`` does not divide the
heads, the train and prefill cells split attention's query sequence over
``model``. ``--save-hlo PATH`` has no HLO to save: it writes
the counted per-op table (every coordinate's ops by name: calls, bytes,
flops) to ``PATH`` instead.

Usage (from the root of a checkout):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch import capture_analysis, perf
from repro_torch.configs import SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.configs import shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import dtype_of
from repro_torch.roofline import roofline_terms
from repro_torch.runtime import steps

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


def _analytic(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``params_*``, ``tokens``, ``model_flops`` and ``min_bytes_global``,
    the JAX package's reckoning."""
    pc = cfg.param_counts()
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        model_flops = 6 * pc["active"] * tokens
        # params read + grads written + opt moments touched, once per step
        min_bytes = pc["total"] * (2 * dtype_bytes + 8)
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        model_flops = 2 * pc["active"] * tokens
        min_bytes = pc["active"] * dtype_bytes
    else:  # decode: one token per sequence; params + cache move once
        tokens = shape.global_batch
        model_flops = 2 * pc["active"] * tokens
        cache = steps.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        cache_bytes = sum(math.prod(t.shape) * t.element_size()
                          for slot in cache for t in slot.values())
        min_bytes = pc["active"] * dtype_bytes + cache_bytes
    return dict(params_total=pc["total"], params_active=pc["active"],
                tokens=tokens, model_flops=model_flops,
                min_bytes_global=min_bytes)


def record(cfg: ArchConfig, shape: ShapeSpec, mesh, *, impl: str = "naive",
           moe_policy: str = "drop", save_hlo: str | None = None,
           opts: perf.PerfOpts | None = None) -> dict:
    """One cell's fields on ``mesh`` (any ``LogicalMesh``; the production
    one in ``run_cell``): ``status`` "ok" and the counts (module
    docstring). Raises what the build or the run raises."""
    t0 = time.perf_counter()
    lowered = steps.lower_for(cfg, mesh, shape, impl=impl,
                              moe_policy=moe_policy, opts=opts)
    t1 = time.perf_counter()
    rep = capture_analysis.analyze_step(
        lowered.compile(), lowered.args, mesh=mesh,
        arg_specs=lowered.arg_specs, op_table=bool(save_hlo))
    t2 = time.perf_counter()
    if save_hlo:
        table = rep.pop("op_table")
        Path(save_hlo).write_text("op calls bytes flops\n" + "".join(
            f"{name} {r['calls']} {r['bytes']} {r['flops']}\n"
            for name, r in table.items()))
    colls = {op: rep["collectives"].get(op, 0.0) for op in COLLECTIVE_OPS}
    rec = dict(
        status="ok",
        chips=int(mesh.size),
        lower_s=round(t1 - t0, 2),
        compile_s=round(t2 - t1, 2),
        flops_per_device=rep["flops"],
        bytes_per_device=rep["bytes"],
        collective_bytes_per_device=colls,
        unknown_trip_whiles=rep["unknown_trip_whiles"],
        xla_reported={"flops": rep["flops"],
                      "bytes_accessed": rep["bytes"]},
        mem=rep["mem"],
        **_analytic(cfg, shape),
    )
    rec["roofline"] = roofline_terms(rec, dtype=dtype_of(cfg))
    return rec


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    impl: str = "naive",
    moe_policy: str = "drop",
    save_hlo: str | None = None,
    opts: perf.PerfOpts | None = None,
) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "impl": impl,
        "moe_policy": moe_policy,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    if opts is not None:
        rec["perf_opts"] = {
            k: getattr(opts, k) for k in opts.__dataclass_fields__
        }
    rec.update(record(cfg, shape, mesh, impl=impl, moe_policy=moe_policy,
                      save_hlo=save_hlo, opts=opts))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--impl", default="naive", choices=["naive", "chunked"])
    ap.add_argument("--moe-policy", default="drop",
                    choices=["drop", "dense", "gather"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-hlo", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-fallback", action="store_true")
    ap.add_argument("--probs-dtype", default=None)
    ap.add_argument("--score-dtype", default=None)
    ap.add_argument("--norm-bf16", action="store_true")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"])
    ap.add_argument("--moe-hints", action="store_true")
    ap.add_argument("--moe-weight-gather", action="store_true")
    ap.add_argument("--attn-block", type=int, default=None)
    args = ap.parse_args()

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from repro_torch.configs import ASSIGNED

        cells = [
            (a, s, m)
            for a in ASSIGNED
            for s in SHAPES
            for m in ("single", "multi")
        ]
    else:
        cells = [(args.arch, args.shape, args.mesh)]

    for arch, shape, mesh_kind in cells:
        tag = f"-{args.tag}" if args.tag else ""
        fname = outdir / f"{arch}--{shape}--{mesh_kind}{tag}.json"
        if fname.exists():
            print(f"[skip existing] {fname}")
            continue
        print(f"[dryrun] {arch} × {shape} × {mesh_kind} ...", flush=True)
        opts = None
        if (
            args.seq_fallback or args.probs_dtype or args.remat_policy
            or args.moe_hints or args.attn_block or args.impl != "naive"
            or args.score_dtype or args.norm_bf16 or args.moe_weight_gather
        ):
            opts = perf.from_flags(
                impl=args.impl,
                seq_shard_fallback=args.seq_fallback or None,
                probs_dtype=args.probs_dtype,
                score_dtype=args.score_dtype,
                remat_policy=args.remat_policy,
                moe_hints=args.moe_hints or None,
                attn_block=args.attn_block,
                norm_bf16=args.norm_bf16 or None,
                moe_weight_gather=args.moe_weight_gather or None,
            )
        try:
            rec = run_cell(
                arch, shape, mesh_kind,
                impl=args.impl, moe_policy=args.moe_policy,
                save_hlo=args.save_hlo, opts=opts,
            )
        except Exception as e:  # a failure here is a bug in the system
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc(),
            }
        fname.write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (
                f" compile={rec['compile_s']}s "
                f"flops/dev={rec['flops_per_device']:.3g}"
                f" coll={sum(rec['collective_bytes_per_device'].values()):.3g}B"
            )
        print(f"[{status}] {arch} × {shape} × {mesh_kind}{extra}", flush=True)


if __name__ == "__main__":
    main()
