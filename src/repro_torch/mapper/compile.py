"""Compile a placed schedule into a program: the port of
``repro.mapper.compile``.

The reference traces the lowering walk once under ``jax.jit`` and gets one
XLA program. PyTorch runs eagerly and the port needs no jit: a
:class:`CompiledProgram` is a Python callable that replays the walk
planned once at compile time (``repro_torch.mapper.lowering.plan``) —
which aten nodes run natively, which through a PIM kernel, and which ride
one fused launch; the block metadata comes from the placement. What is
left per call depends on the argument values: operand padding, the
launches and the native ops.

    prog = compile_schedule(schedule)     # CompiledProgram, callable
    prog(*args)                           # runs through the placement

Programs execute **grouped**: each placed node's whole block grid rides
one ``pim_matmul_grouped`` (K1) launch (independent same-shape placed
nodes are additionally coalesced), so a call launches about one kernel
per placed node instead of one per block.
``placed_blocks`` counts block-level work and ``kernel_launches`` the
launches, both **of the last call** (the reference counts per trace,
which is the same number); the executor stays the per-block oracle and
grouped results are bit-identical to it.

Programs are cached by ``(fn, argument shapes and dtypes, placement
signature, activation width, device)``: compiling the same schedule twice
returns the identical ``CompiledProgram``. The reference's key also holds
the tile edge and the group/fuse switches; the port's programs always run
grouped and fused over ``lowering.TILE``, so those parts are constant.

The executor remains the oracle: ``CompiledProgram.verify`` checks the
program against both the executor and the plain function.

Not ported yet: partitioned programs (``compile_partitioned``,
``StageProgram``, ``PartitionedProgram``; ROADMAP.md, queue item 3.3) and
differentiation through a program (queue item 3.1).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.mapper.executor import (ScheduleExecutor, flatten_args,
                                         full_float32, max_deviation)
from repro_torch.mapper.lowering import LoweringContext, eval_placed
from repro_torch.mapper.schedule import Schedule


@dataclasses.dataclass
class CompiledProgram:
    """One schedule lowered to a callable on ``device``.

    Calling the program replays the planned walk on the arguments (the
    pytree structure and shapes the schedule was traced with, on
    ``device``) and returns the function's output.
    """

    schedule: Schedule
    ctx: LoweringContext
    device: torch.device

    def __call__(self, *args, **kwargs):
        flat = flatten_args(self.schedule, self.device, args, kwargs)
        self.ctx.reset_counters()
        tr = obs.tracer()
        with torch.no_grad():
            if not tr.enabled:
                outs = eval_placed(self.ctx, flat)
            else:
                # the whole call as one execute-lane span, synced so dur
                # covers the device work; the per-node launch spans nest
                # under it
                with tr.span("program:call", lane="execute"):
                    outs = eval_placed(self.ctx, flat)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        return pytree.tree_unflatten(outs, self.schedule.graph.out_spec)

    @property
    def placed_blocks(self) -> int:
        """Placed block matmuls of the last call (work)."""
        return self.ctx.placed_blocks

    @property
    def eltwise_calls(self) -> int:
        return self.ctx.eltwise_calls

    @property
    def kernel_launches(self) -> int:
        """Kernel launches of the last call (grouped/fused launches count
        once)."""
        return self.ctx.kernel_launches

    @property
    def matmul_launches(self) -> int:
        return self.ctx.matmul_launches

    @property
    def eltwise_launches(self) -> int:
        return self.ctx.eltwise_launches

    def verify(self, *args, rtol: float = 1e-4, atol: float = 1e-4,
               **kwargs) -> float:
        """Check the program against both oracles — the per-block executor
        and the plain function (float32, TF32 off). Returns the max abs
        deviation from the plain function."""
        got = self(*args, **kwargs)
        interp = ScheduleExecutor(self.schedule,
                                  device=self.device).run(*args, **kwargs)
        max_deviation(got, interp, rtol, atol)
        fn = self.schedule.graph.fn
        if fn is None:
            return 0.0
        with torch.no_grad(), full_float32():
            want = fn(*args, **kwargs)
        return max_deviation(got, want, rtol, atol)


# ---------------------------------------------------------------------------
# program cache
# ---------------------------------------------------------------------------

# LRU-bounded: fn identity is part of the key, so per-call closures can
# never hit — without eviction they would pin their schedules forever.
_CACHE: "collections.OrderedDict[tuple, CompiledProgram]" = \
    collections.OrderedDict()
_CACHE_MAX = 32
_STATS = {"hits": 0, "misses": 0}


def _program_key(schedule: Schedule, device: torch.device) -> tuple:
    avals = tuple((tuple(fx.meta["val"].shape), str(fx.meta["val"].dtype))
                  for fx in schedule.graph.gm.graph.nodes
                  if fx.op == "placeholder")
    fn = schedule.graph.fn
    fn_key: Any = fn if fn is not None else id(schedule.graph.gm)
    # placement.signature() folds in the hierarchy fingerprint (tech +
    # tile/chip geometry), so same-grid placements on different machines
    # get distinct keys
    return (fn_key, avals, schedule.placement.signature(),
            schedule.act_bits, str(device))


def program_cache_stats() -> dict[str, int]:
    return {"hits": _STATS["hits"], "misses": _STATS["misses"],
            "size": len(_CACHE)}


def clear_program_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


def compile_schedule(schedule: Schedule, *, use_cache: bool = True,
                     device: str | torch.device | None = None
                     ) -> CompiledProgram:
    """Lower ``schedule`` into one program running on ``device`` (CUDA by
    default). The returned :class:`CompiledProgram` is callable with
    exactly the arguments the schedule's fn was traced with."""
    dev = resolve_device(device)
    if use_cache:
        key = _program_key(schedule, dev)
        hit = _CACHE.get(key)
        if hit is not None:
            _STATS["hits"] += 1
            obs.metrics().counter("compile.cache_hits").inc()
            _CACHE.move_to_end(key)
            return hit
        _STATS["misses"] += 1
        obs.metrics().counter("compile.cache_misses").inc()
    ctx = LoweringContext(schedule)
    program = CompiledProgram(schedule=schedule, ctx=ctx, device=dev)
    if use_cache:
        _CACHE[key] = program
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return program
