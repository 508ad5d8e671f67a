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
per placed node instead of one per block. Over a sub-fp32 weight grid
(``weight_dtype``) that launch is ``pim_matmul_grouped_q`` (K5) on the
stationary operand's codes and scales.
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

Differentiable, as the reference's ``jax.grad(prog.fn)``: when an argument
requires grad, the call records autograd's graph, and the placed
products' and MACs' cotangents come from the kernels' own backward passes
(``repro_torch.kernels.pim_mac``); the native ops differentiate as torch
ops. Otherwise the call runs under ``torch.no_grad()``.

**Partitioned programs**: when a schedule was built with pipeline
partitions (``build_schedule(..., partitions=K)``),
:func:`compile_partitioned` lowers each partition into its own
:class:`StageProgram` — a function over exactly the values that cross its
boundaries. Stage inputs/outputs are *explicit transfer points*: each
input is tagged with its provenance (a program argument or an earlier
stage's output), so a driver — sequential
(``PartitionedProgram.__call__``) or the GPipe microbatch loop in
``repro_torch.parallel.pipeline`` — can stream activation sets through
the stages without re-deriving dataflow. Running the stages in order
equals the unpartitioned program bit for bit: the same kernels on the
same blocks in the same order, only the fused launches cut at the
boundaries (``lowering.stage_steps``).
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.mapper.executor import (ScheduleExecutor, flatten_args,
                                         full_float32, max_deviation)
from repro_torch.mapper import placement as placement_mod
from repro_torch.mapper.lowering import (LoweringContext, eval_placed,
                                         eval_steps, stage_steps)
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
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in flat)
        with torch.set_grad_enabled(grad):
            if not tr.enabled:
                outs = eval_placed(self.ctx, flat)
            else:
                # the whole call as one execute-lane span, synced so dur
                # covers the device work; the per-node launch spans nest
                # under it
                with tr.span("program:call", lane="execute",
                             sync=self.device.type == "cuda"):
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


def _program_key(schedule: Schedule, device: torch.device,
                 boundaries: tuple = (), streams: tuple = ()) -> tuple:
    avals = tuple((tuple(fx.meta["val"].shape), str(fx.meta["val"].dtype))
                  for fx in schedule.graph.gm.graph.nodes
                  if fx.op == "placeholder")
    fn = schedule.graph.fn
    fn_key: Any = fn if fn is not None else id(schedule.graph.gm)
    # placement.signature() folds in the hierarchy fingerprint (tech,
    # the subarray's weight grid, tile/chip geometry), so placements on
    # different machines or weight grids get distinct keys; a partitioned
    # program's stage boundaries and its ring of streams are part of it
    return (fn_key, avals, schedule.placement.signature(),
            schedule.act_bits, str(device), boundaries,
            tuple(id(s) for s in streams))


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


# ---------------------------------------------------------------------------
# partitioned programs (one stage program per pipeline partition)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageProgram:
    """One pipeline partition lowered to a function.

    ``fn(*invals) -> tuple(outvals)`` evaluates exactly this partition's
    units' aten nodes through the shared plan (placed nodes on the
    kernels). ``in_refs[i]`` names where input ``i`` comes from —
    ``("arg", flat_idx)`` for a program argument or ``("stage", s, j)``
    for output ``j`` of an earlier stage — making every inter-stage
    transfer explicit for the microbatch driver. ``stream``: the CUDA
    stream the asynchronous drivers run it on (the reference's pinned
    device; None, the caller's stream). The counters are those of the
    stage's last call.
    """

    idx: int
    fn: Callable
    in_refs: tuple[tuple, ...]
    n_outs: int
    out_bits: int                 # activation bits this stage streams out
    stream: Any = None
    matmul_launches: int = 0
    eltwise_launches: int = 0


_COUNTERS = ("matmul_launches", "eltwise_launches")


def _stage_fn(ctx: LoweringContext, plan, device: torch.device,
              stage: StageProgram) -> Callable:
    """The function of one stage: its walk over the values it is given,
    its counters set to what the walk added to the program's."""
    def fn(*invals):
        before = [getattr(ctx, c) for c in _COUNTERS]
        outs = eval_steps(ctx, plan.steps, invals, device, plan.outs)
        for c, b in zip(_COUNTERS, before):
            setattr(stage, c, getattr(ctx, c) - b)
        return tuple(outs)
    return fn


@dataclasses.dataclass
class PartitionedProgram:
    """A schedule compiled as one program per pipeline partition.

    Calling the program runs the stages in order — bit for bit the
    unpartitioned ``CompiledProgram`` (module docstring). The stage list
    is the real pipeline surface: ``repro_torch.parallel.pipeline``
    streams microbatches through ``stages`` with GPipe fill/drain and
    differentiates them per stage. The counters are those of the last
    call, summed over its stages; ``stage_trace_count`` counts the stage
    programs built (the reference counts its stage bodies' traces: the
    port plans each stage once, when it is compiled).
    """

    schedule: Schedule
    partitions: list
    stages: list[StageProgram]
    out_refs: tuple[tuple, ...]
    ctx: LoweringContext
    device: torch.device
    stage_trace_count: int = 0

    def __call__(self, *args, **kwargs):
        flat = self.flatten_args(*args, **kwargs)
        self.ctx.reset_counters()
        tr = obs.tracer()
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in flat)
        with torch.set_grad_enabled(grad):
            if not tr.enabled:
                outs = self._run(flat)
            else:
                with tr.span("program:call", lane="execute",
                             partitions=len(self.stages),
                             sync=self.device.type == "cuda"):
                    outs = self._run(flat)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        return self.unflatten_outs(outs)

    def _run(self, flat: list, on_streams: bool = False) -> list:
        """The stages in order on one activation set. ``on_streams``:
        each stage on its stream, after an event recorded where the stage
        before it ran, its inputs held on its stream for the caching
        allocator; the outputs are handed back on the caller's stream
        with no host sync."""
        stage_outs: list[tuple] = []

        def resolve(ref):
            if ref[0] == "arg":
                return flat[ref[1]]
            if ref[0] == "stage":
                return stage_outs[ref[1]][ref[2]]
            return ref[1]                  # ("lit", val)

        main = torch.cuda.current_stream() if on_streams else None
        last = main.record_event() if on_streams else None
        for st in self.stages:
            ins = [resolve(r) for r in st.in_refs]
            if main is None:
                stage_outs.append(st.fn(*ins))
                continue
            stream = st.stream or main
            stream.wait_event(last)
            for x in ins:
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(stream)
            with torch.cuda.stream(stream):
                stage_outs.append(st.fn(*ins))
            last = stream.record_event()
        outs = [resolve(r) for r in self.out_refs]
        if main is not None:
            main.wait_event(last)
            for x in outs:
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(main)
        return outs

    @property
    def n_partitions(self) -> int:
        return len(self.stages)

    @property
    def streams(self) -> tuple:
        """Per-stage streams (``None`` entries: the caller's stream)."""
        return tuple(st.stream for st in self.stages)

    def run_async(self, *args, **kwargs):
        """Run the stages in order, each on its own stream of the ring
        with events at the cut points (``_run(on_streams=True)``), without
        a host sync: the outputs are ready on the caller's stream. Bit for bit
        ``self(*args)``: the same stage programs in the same order."""
        self.ctx.reset_counters()
        flat = self.flatten_args(*args, **kwargs)
        with torch.no_grad():
            outs = self._run(flat, on_streams=self.device.type == "cuda")
        return self.unflatten_outs(outs)

    @property
    def placed_blocks(self) -> int:
        return self.ctx.placed_blocks

    @property
    def eltwise_calls(self) -> int:
        return self.ctx.eltwise_calls

    @property
    def kernel_launches(self) -> int:
        return self.ctx.kernel_launches

    @property
    def matmul_launches(self) -> int:
        return self.ctx.matmul_launches

    @property
    def eltwise_launches(self) -> int:
        return self.ctx.eltwise_launches

    def flatten_args(self, *args, **kwargs) -> list:
        """Flatten a call's arguments exactly like the program does,
        checking the traced pytree structure and the device — drivers use
        this to build the per-microbatch flat argument lists the stage
        ``in_refs`` index into."""
        return flatten_args(self.schedule, self.device, args, kwargs)

    def unflatten_outs(self, out_flat: list):
        return pytree.tree_unflatten(list(out_flat),
                                     self.schedule.graph.out_spec)

    def verify(self, *args, rtol: float = 1e-4, atol: float = 1e-4,
               **kwargs) -> float:
        """Check the partitioned program against both oracles — the
        per-block executor and the plain function (float32, TF32 off).
        Returns the max abs deviation from the plain function."""
        got = self(*args, **kwargs)
        interp = ScheduleExecutor(self.schedule,
                                  device=self.device).run(*args, **kwargs)
        max_deviation(got, interp, rtol, atol)
        fn = self.schedule.graph.fn
        assert fn is not None, "graph was built without a fn reference"
        with torch.no_grad(), full_float32():
            want = fn(*args, **kwargs)
        return max_deviation(got, want, rtol, atol)


def compile_partitioned(schedule: Schedule, *,
                        partitions: int | None = None,
                        use_cache: bool = True,
                        device: str | torch.device | None = None,
                        streams=None) -> PartitionedProgram:
    """Lower ``schedule`` into one program per pipeline partition, running
    on ``device`` (CUDA by default).

    Uses the partitions the schedule was built with
    (``build_schedule(..., partitions=K)``); pass ``partitions=K`` to cut
    here instead. Each stage program consumes exactly the values crossing
    its upstream boundary (tagged with provenance) and returns the values
    crossing its downstream boundary — the explicit transfer points the
    microbatch pipeline driver streams.

    ``streams`` (a sequence of CUDA streams, the reference's ``devices``)
    assigns stage ``i`` to ``streams[i % len(streams)]``: the
    asynchronous drivers (``PartitionedProgram.run_async``,
    ``repro_torch.parallel.pipeline.run_partitioned_async``) and the GPipe
    gradient (``gpipe_value_and_grad``) run each stage on its stream,
    ordered by events at the cut points.
    """
    dev = resolve_device(device)
    parts = schedule.partitions
    if partitions is not None:
        parts = placement_mod.partition(schedule.graph, partitions)
    if not parts:
        raise ValueError(
            "schedule has no pipeline partitions; build it with "
            "build_schedule(..., partitions=K) or pass partitions=K")
    ring = tuple(streams) if streams else ()
    if ring and dev.type != "cuda":
        raise ValueError(f"a ring of CUDA streams needs a CUDA device, "
                         f"not {dev}")
    boundaries = tuple((p.unit_start, p.unit_end) for p in parts)
    if use_cache:
        key = _program_key(schedule, dev, boundaries, ring)
        hit = _CACHE.get(key)
        if hit is not None and isinstance(hit, PartitionedProgram):
            _STATS["hits"] += 1
            obs.metrics().counter("compile.cache_hits").inc()
            _CACHE.move_to_end(key)
            return hit
        _STATS["misses"] += 1
        obs.metrics().counter("compile.cache_misses").inc()

    ctx = LoweringContext(schedule, boundaries=boundaries)
    gm = schedule.graph.gm
    arg_of = {fx: i for i, fx in enumerate(
        fx for fx in gm.graph.nodes if fx.op == "placeholder")}
    produced_by: dict[torch.fx.Node, tuple[int, int]] = {}
    program = PartitionedProgram(schedule=schedule, partitions=list(parts),
                                 stages=[], out_refs=(), ctx=ctx,
                                 device=dev)

    def ref(v) -> tuple:
        if not isinstance(v, torch.fx.Node):
            return ("lit", v)
        if v in arg_of:
            return ("arg", arg_of[v])
        return ("stage", *produced_by[v])

    for s, plan in enumerate(stage_steps(ctx)):
        stage = StageProgram(
            idx=s, fn=None, in_refs=tuple(ref(v) for v in plan.ins),
            n_outs=len(plan.outs),
            out_bits=sum(math.prod(v.meta["val"].shape)
                         * v.meta["val"].element_size() * 8
                         for v in plan.outs),
            stream=ring[s % len(ring)] if ring else None)
        stage.fn = _stage_fn(ctx, plan, dev, stage)
        produced_by.update((v, (s, j)) for j, v in enumerate(plan.outs))
        program.stages.append(stage)
        program.stage_trace_count += 1
    output = next(fx for fx in gm.graph.nodes if fx.op == "output")
    program.out_refs = tuple(ref(v) for v in output.args[0])
    if use_cache:
        _CACHE[key] = program
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return program
