"""Fault-tolerant training loop: the port of ``repro.train.trainer``.

Composes a step function, an optimizer (``repro_torch.optim``), the
stateless-resumable data pipeline, the checkpoint manager and the
heartbeat/straggler monitors. As in the reference:

  * **auto-resume**: on construction the trainer restores the newest
    complete checkpoint and continues from that step; because the data
    pipeline is a pure function of the step counter, the resumed run sees
    exactly the batches the uninterrupted run would have;
  * **crash-safety**: checkpoints are atomic (temp+rename) and written
    asynchronously every ``ckpt_every`` steps;
  * **failure injection**: ``fail_at_step`` simulates a mid-run node death
    (raises) — the test restarts the trainer and verifies bit-identical
    convergence with an uninterrupted run;
  * **straggler events** recorded via ``StragglerPolicy``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch._tree import leaves_with_path, tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.monitor import HeartbeatMonitor, StragglerPolicy


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    async_ckpt: bool = True
    fail_at_step: int | None = None    # failure injection (tests)


class Trainer:
    def __init__(self, cfg: TrainerConfig, *, train_step: Callable,
                 init_state: Callable[[], tuple[Any, Any]],
                 batch_fn: Callable[[int], Any],
                 backend: str = "jit", pim_tech: str = "proposed",
                 weight_dtype: str = "fp32", act_dtype: str = "fp32",
                 microbatches: int = 1, partitions: int = 1,
                 loss_fn: Callable | None = None, optimizer=None,
                 device: str | torch.device | None = None,
                 pim_compile: dict | None = None):
        """``train_step(params, opt_state, batch) -> (params, opt, loss)``;
        ``init_state()`` builds fresh (params, opt_state) on ``device``
        (CUDA by default); ``batch_fn(step)`` is the stateless data
        pipeline, whose numpy leaves the trainer moves to ``device``.

        ``backend="jit"`` runs ``train_step`` as it is: eager PyTorch, the
        plain step (the name is the reference's, whose step runs under
        ``jax.jit``). ``backend="pim"`` maps the whole loss + grad +
        optimizer step onto the PIM hierarchy once and runs the compiled
        schedule — every placed product and MAC through the port's PIM
        kernels (``repro_torch.mapper.compile``). The placed schedule is
        ``self.pim_program.schedule``.

        ``weight_dtype`` (pim backend only) stores placed weights on a
        reduced-precision grid (``int8`` / ``fp8_e4m3`` / ``fp8_e5m2`` /
        ``fp16``): denser placement, more throughput replicas, and
        dequantize-on-load products (K5) with float32 accumulation and
        straight-through gradients (``core.quant.quantize_ste``).
        ``act_dtype`` (pim backend only) prices inter-stage activation
        transfers on the modeled NoC at the grid's width; compute stays
        float32.

        ``microbatches=M`` / ``partitions=K`` (pim backend only) run the
        *partitioned pipeline plan*: the loss graph is cut into K pipeline
        partitions compiled one program each, the batch is split into M
        equal microbatches, and each step streams them through the stage
        programs with GPipe fill-drain, differentiating per stage
        (``repro_torch.parallel.pipeline.gpipe_value_and_grad``) and
        applying one optimizer update on the microbatch-mean gradients.
        Requires ``loss_fn(params, *batch) -> scalar mean loss`` and an
        ``optimizer`` with ``update(grads, opt_state, params)`` (the
        opaque ``train_step`` cannot be split); losses match the plain
        step to fp32 tolerance because a mean over equal microbatch means
        is the full-batch mean. ``pipeline_stats`` holds the last step's
        kernel launches per stage, forward and backward.

        ``pim_compile`` forwards knobs to the schedule compiler (e.g.
        ``{"streams": [...]}`` with partitions: each stage's cells on its
        own CUDA stream, the reference's pinned devices)."""
        if microbatches < 1 or partitions < 1:
            raise ValueError("microbatches and partitions must be >= 1")
        if backend not in ("jit", "pim"):
            raise ValueError(f"backend must be 'jit' or 'pim', "
                             f"got {backend!r}")
        pipelined = microbatches > 1 or partitions > 1
        if pipelined and backend != "pim":
            raise ValueError(
                "microbatches/partitions require backend='pim' (the jit "
                "backend has no partitioned plan to pipeline)")
        if backend != "pim" and weight_dtype != "fp32":
            raise ValueError(
                "weight_dtype only applies to backend='pim' (the jit "
                "backend has no placed weight grid to quantize)")
        if backend != "pim" and act_dtype != "fp32":
            raise ValueError(
                "act_dtype only applies to backend='pim' (the jit "
                "backend has no modeled NoC to narrow transfers on)")
        if backend == "jit" and pim_compile:
            raise ValueError("pim_compile only applies to backend='pim'")
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.backend = backend
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                      async_save=cfg.async_ckpt)
        self.straggler = StragglerPolicy()
        self.heartbeat = HeartbeatMonitor()
        self.pim_program = None
        self.microbatches = microbatches
        self.partitions = partitions
        self.pipeline_stats: dict = {}
        self._pim_compile = dict(pim_compile or {})

        params, opt_state = init_state()
        if backend == "jit":
            self._step_fn = train_step
        elif pipelined:
            self._step_fn = self._build_pipelined_step(
                params, loss_fn, optimizer, pim_tech, weight_dtype,
                act_dtype)
        else:
            from repro_torch import mapper
            abstract = mapper.abstract_like
            sched = mapper.build_schedule(
                train_step, abstract(params), abstract(opt_state),
                abstract(self._batch(0)), tech=pim_tech,
                weight_dtype=weight_dtype, act_dtype=act_dtype)
            # use_cache=False: the program cache keys on fn identity, and
            # this per-instance train_step would never hit but would be
            # pinned forever
            self.pim_program = mapper.compile_schedule(
                sched, use_cache=False, device=self.device,
                **self._pim_compile)
            self._step_fn = self.pim_program
        restored, step = self.ckpt.restore({"params": params,
                                            "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            self.start_step = step + 1
            self.resumed = True
        else:
            self.start_step = 0
            self.resumed = False
        self.params = params
        self.opt_state = opt_state
        self.losses: list[float] = []

    def _build_pipelined_step(self, params, loss_fn, optimizer,
                              pim_tech: str, weight_dtype: str,
                              act_dtype: str) -> Callable:
        """The partitioned microbatch-pipeline step (see ``__init__``):
        ``loss_fn`` mapped at microbatch shape, cut into
        ``self.partitions`` stage programs; the step GPipe-streams the
        microbatches and applies one update on the mean gradients, run
        natively as the reference runs it."""
        if loss_fn is None or optimizer is None:
            raise ValueError(
                "microbatches/partitions need loss_fn and optimizer: an "
                "opaque train_step cannot be cut into pipeline stages")
        from repro_torch import mapper
        from repro_torch.parallel import pipeline as pipe_mod

        n_micro = self.microbatches
        batch0 = self._batch(0)
        leaves = pytree.tree_leaves(batch0)
        if not leaves:
            raise ValueError("batch_fn(0) returned an empty batch")
        batch_dim = leaves[0].shape[0]
        if any(x.shape[0] != batch_dim for x in leaves):
            raise ValueError("all batch leaves must share the leading "
                             "(batch) axis to be microbatched")
        if batch_dim % n_micro:
            raise ValueError(f"batch size {batch_dim} is not divisible "
                             f"into {n_micro} microbatches")
        mb = batch_dim // n_micro

        def slice_mb(batch, m):
            return pytree.tree_map(lambda a: a[m * mb:(m + 1) * mb], batch)

        sched = mapper.build_schedule(
            loss_fn, mapper.abstract_like(params),
            *mapper.abstract_like(slice_mb(batch0, 0)), tech=pim_tech,
            weight_dtype=weight_dtype, act_dtype=act_dtype,
            partitions=self.partitions)
        # use_cache=False: the program cache keys on fn identity, and
        # per-instance programs would be pinned forever
        prog = mapper.compile_partitioned(sched, use_cache=False,
                                          device=self.device,
                                          **self._pim_compile)
        self.pim_program = prog
        loss_ref = prog.out_refs[0]
        param_leaves, param_spec = pytree.tree_flatten(params)
        grad_argnums = list(range(len(param_leaves)))

        def step(params, opt_state, batch):
            flat_per_mb = [prog.flatten_args(params, *slice_mb(batch, m))
                           for m in range(n_micro)]
            self.pipeline_stats = {}
            loss, grad_flat = pipe_mod.gpipe_value_and_grad(
                prog.stages, loss_ref, flat_per_mb, grad_argnums,
                stats=self.pipeline_stats)
            grads = pytree.tree_unflatten(grad_flat, param_spec)
            with torch.no_grad():
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
            return params, opt_state, loss

        return step

    def _batch(self, step: int):
        """``batch_fn(step)`` with its numpy leaves as tensors on the
        trainer's device."""
        return tree_map(
            lambda x: (torch.as_tensor(x, device=self.device)
                       if isinstance(x, np.ndarray) else x),
            self.batch_fn(step))

    def run(self) -> dict:
        cfg = self.cfg
        m = obs.metrics()
        step = self.start_step
        first_step = True
        while step < cfg.total_steps:
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.monotonic()
            with obs.span("train:step", lane="train", step=step):
                batch = self._batch(step)
                self.params, self.opt_state, loss = self._step_fn(
                    self.params, self.opt_state, batch)
                loss = float(loss)    # device sync: dt is true step time
            dt = time.monotonic() - t0
            m.histogram("train.step_wall_s").observe(dt)
            if first_step:
                # the resumed-run first step pays the kernels' first
                # launches; record it apart so the steady-state histogram
                # stays clean
                m.gauge("train.first_step_wall_s").set(dt)
                first_step = False
            m.counter("train.steps").inc()
            self.heartbeat.beat("host0")
            self.straggler.observe(step, dt)
            self.losses.append(loss)
            if step % cfg.ckpt_every == 0 and step > self.start_step:
                self.ckpt.save(step, {"params": self.params,
                                      "opt": self.opt_state})
            step += 1
        # final checkpoint
        self.ckpt.save(cfg.total_steps - 1,
                       {"params": self.params, "opt": self.opt_state})
        self.ckpt.wait()
        return {
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "losses": self.losses,
            "resumed": self.resumed,
            "start_step": self.start_step,
            "straggler_events": self.straggler.events,
        }


def eval_accuracy(apply_fn, params, images: np.ndarray,
                  labels: np.ndarray, batch: int = 500) -> float:
    """Top-1 accuracy of ``apply_fn(params, images)`` over numpy images,
    fed in batches on the parameters' device."""
    _, leaf = next(leaves_with_path(params))
    correct = 0
    with torch.no_grad():
        for i in range(0, len(images), batch):
            logits = apply_fn(params, torch.as_tensor(images[i:i + batch],
                                                      device=leaf.device))
            correct += int((logits.argmax(-1).cpu().numpy()
                            == labels[i:i + batch]).sum())
    return correct / len(images)
