"""End-to-end trainer (the port's copy of ``repro.launch.train``):
deterministic resumable data, AdamW with a cosine schedule, async
checkpointing, a step-time straggler watchdog, optional gradient
compression (int8, no error feedback) and ``--preset 100m`` for the
~100M-parameter run. Runs on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --arch granite-moe-1b-a400m --mesh 2x2 --devices "cpu cpu cpu cpu"
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --arch internvl2-1b --mesh 1x4 --devices "cpu cpu cpu cpu"

``--mesh DPxMP`` (or ``PODxDPxMP``) trains on a mesh of logical devices
(``runtime.steps.make_mesh_train_fn``: FSDP over ``data``, tensor
parallelism over ``model``, ZeRO over ``pod`` where the config asks; an
embeddings arch on the pipeline's float inputs) over
``--devices``, one per coordinate (default ``--device`` at every one: one
card named several times); checkpoints hold the joined state, so a run
resumes onto any mesh. Weights come from ``models.init_params(cfg, seed=0)``, batches from
``data.pipeline.SyntheticLM`` (seed 0), moved to the device here. The log
lines are the JAX launcher's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import models
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.collectives import make_grad_compressor
from repro_torch.ft.failover import StepTimeWatchdog
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (TrainState, make_mesh_train_fn,
                                       make_train_fn, place_train_state)


def preset_100m(base):
    """~124M params (GPT-2-medium-ish) of the same family as --arch."""
    return dataclasses.replace(
        base,
        name=base.name + "-100m",
        num_layers=12 if base.period == 1 else base.period * 2,
        d_model=768,
        num_heads=12,
        num_kv_heads=min(base.num_kv_heads or 12, 12) or 12,
        head_dim=64,
        d_ff=3072,
        vocab_size=50304,
        remat="none",
        dtype="float32",
    ).validate()


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--preset", default="", choices=["", "100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-torch-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' trains there)")
    ap.add_argument("--mesh", default="1x1",
                    help="'DPxMP' or 'PODxDPxMP': train on a mesh of "
                         "logical devices over --devices")
    ap.add_argument("--devices", default="",
                    help="space-separated, one per mesh coordinate "
                         "(default --device at every coordinate)")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.preset == "100m":
        cfg = preset_100m(cfg)
    print(f"[train] {cfg.name}: {cfg.param_counts()['total']/1e6:.1f}M params")

    opt_cfg = adamw.AdamWConfig(
        peak_lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )

    compress = None
    if args.grad_compress:
        # stateless (no error-feedback) variant, as the JAX launcher's
        cfn, init_residual = make_grad_compressor(bits=8, error_feedback=False)
        compress = lambda g: cfn(g, init_residual(g))[0]  # noqa: E731

    shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    mesh = None
    if shape != (1, 1):
        if len(shape) not in (2, 3) or compress is not None:
            raise SystemExit("--mesh takes DPxMP or PODxDPxMP, without "
                             "--grad-compress")
        axes = ("pod", "data", "model")[-len(shape):]
        n = 1
        for s in shape:
            n *= s
        mesh = make_debug_mesh(shape, axes, devices=(
            args.devices.split() or [str(device)] * n))
        print(f"[train] mesh {dict(zip(axes, shape))}")
        step_fn = make_mesh_train_fn(cfg, mesh, opt_cfg)
    else:
        step_fn = make_train_fn(cfg, opt_cfg, grad_compress=compress)

    params = models.init_params(cfg, seed=0, device=device)
    state = TrainState(params=params, opt=adamw.init(params))
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, state = mgr.restore(state)
        print(f"[train] resumed from step {start}")
    if mesh is not None:
        state = place_train_state(cfg, state, mesh)
        device = mesh.device(mesh.coords()[0])

    data = SyntheticLM(cfg, DataConfig(args.batch, args.seq, seed=0))
    pf = Prefetcher(data, start_step=start)
    wd = StepTimeWatchdog()
    t_last = time.perf_counter()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            state, metrics = step_fn(state, _to_device(batch, device))
            loss = float(metrics["loss"])  # waits for the step
            now = time.perf_counter()
            if wd.observe(step, now - t_last):
                print(f"[train] straggler flagged at step {step} "
                      f"({now - t_last:.2f}s vs ema)")
            t_last = now
            if step % args.log_every == 0:
                print(
                    f"[train] step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e}",
                    flush=True,
                )
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state, meta={"arch": cfg.name})
    finally:
        pf.close()
        mgr.wait()
    mgr.save(args.steps, state, meta={"arch": cfg.name})
    mgr.wait()
    print(f"[train] done at step {args.steps}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
