"""Training launcher: config -> mesh -> sharding rules -> fault-tolerant
trainer. The port of ``repro.launch.train``: the production mesh spans
pods; on one host it runs reduced (smoke) configs on the local ranks.

    python -m repro_torch.launch.train --arch llama3-8b --steps 50 \\
        [--smoke] [--model-axis 1]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-axis 2

On any mesh, one rank's included, the params, the AdamW state and each
batch are DTensors laid out by ``parallel.sharding``'s rules, and each
step returns them to those layouts (the reference's ``device_put`` onto
``NamedSharding``s and its jit's shardings).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.data import TokenStream
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     release_group)
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.train import Trainer, TrainerConfig


def sharded_train_step(step, mesh, p_specs, o_specs):
    """``step`` with its new params and optimizer state returned to their
    layouts (a jit's ``out_shardings``), so every step starts from the
    layout the checkpoints and the next step expect."""

    def run_step(params, opt_state, batch):
        params, opt_state, loss = step(params, opt_state, batch)
        return (sharding.distribute(params, p_specs, mesh),
                sharding.distribute(opt_state, o_specs, mesh), loss)

    return run_step


def run(cfg, *, mesh, steps: int, batch: int, seq: int, lr: float,
        ckpt: str, device=None, name: str | None = None) -> dict:
    """The body of the reference's ``main``: ``cfg`` trained for ``steps``
    AdamW steps on ``mesh`` by a ``Trainer`` that resumes from ``ckpt``,
    laid out by the cell's shardings (``steps.cell_shardings``: the
    single-pod rules, fsdp as the config says); prints the reference's
    line and returns the trainer's result."""
    dev = resolve_device(device)
    cell = steps_mod.cell_shardings(
        mesh, cfg, configs.ShapeSpec("launch", seq, batch, "train"))
    model = DecoderLM(cfg, device=dev)
    opt = make_optimizer("adamw", lr=lr, state_dtype=cfg.opt_state_dtype)
    ts = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq,
                     batch_size=batch, seed=0)
    step = sharded_train_step(
        steps_mod.make_train_step(cfg, optimizer_name="adamw", lr=lr),
        mesh, cell.params, cell.opt_state)

    def batch_fn(i):
        return sharding.distribute(
            {k: torch.as_tensor(v, device=dev)
             for k, v in ts.batch(i).items()}, cell.batch, mesh)

    def init_state():
        params = model.init(0).stacked_params()
        return (sharding.distribute(params, cell.params, mesh),
                sharding.distribute(opt.init(params), cell.opt_state, mesh))

    with sharding.use_rules(cell.rules):
        tr = Trainer(TrainerConfig(total_steps=steps, ckpt_every=25,
                                   ckpt_dir=ckpt),
                     train_step=step, init_state=init_state,
                     batch_fn=batch_fn, device=dev)
        res = tr.run()
    shape = sharding.mesh_axes(mesh)
    # a run resumed at its last step takes none: its first loss is nan
    first = res["losses"][0] if res["losses"] else float("nan")
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"{name or cfg.name} on {shape}: loss {first:.3f} "
              f"-> {res['final_loss']:.3f}  (resumed={res['resumed']}, "
              f"stragglers={len(res['straggler_events'])})", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (full configs need a fleet)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_ckpt"))
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.input_embed_stub:
        raise SystemExit("audio/vlm archs need the frontend-stub driver")

    started = not dist.is_initialized()
    try:
        if args.production_mesh:
            mesh = make_production_mesh()
        else:
            mesh = make_host_mesh(model_axis=args.model_axis)
        return run(cfg, mesh=mesh, steps=args.steps, batch=args.batch,
                   seq=args.seq, lr=args.lr, ckpt=args.ckpt, name=args.arch)
    finally:
        if started:
            release_group()


if __name__ == "__main__":
    main()
