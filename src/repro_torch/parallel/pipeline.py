"""GPipe pipelines: the port of ``repro.parallel.pipeline``.

The GPipe schedule is classic fill-drain over M microbatches and P stages
— T = M + P - 1 ticks; at tick t, stage s processes microbatch (t - s)
when 0 <= t - s < M; bubble fraction = (P-1)/(M+P-1). Two substrates
share it:

  * **mesh pipelining** (:func:`pipeline_forward` /
    :func:`make_pipelined_fn`): the ranks of a mesh axis (``"pod"``)
    carry the stages, each holding a contiguous slice of the layer stack
    (params stacked per stage, [P, layers_per_stage, ...]); each tick a
    stage hands its output to the next by a point-to-point send and
    receive, and the last stage's outputs reach every rank of the axis by
    a SUM all-reduce of the masked value. A forward (inference) pipeline:
    nothing is differentiated through the transfers.

The other substrate runs the stages on one device: the stages are the
per-partition programs of
``repro_torch.mapper.compile.compile_partitioned``: weight blocks stay
resident on their tiles and activation sets stream through the explicit
transfer points (``StageProgram.in_refs``).

  * :func:`run_partitioned` walks the grid on the caller's stream;
  * :func:`run_partitioned_async` runs each stage on its own CUDA stream
    (``compile_partitioned(..., streams=...)``, the reference's ring of
    pinned devices): a value crossing a cut goes through an event the
    producer's stream records and the consumer's waits on, and the
    consumer records the tensor on its stream for the caching allocator.
    No host sync until the caller reads the outputs. Stages without a
    stream run on the caller's; on the CPU there are none, and the driver
    is the synchronous one;
  * :func:`gpipe_value_and_grad` differentiates *per stage*: each
    (microbatch, stage) forward runs under ``torch.enable_grad()`` on
    detached inputs that require grad, and the walk in reverse calls
    ``torch.autograd.grad`` on the stashed outputs — the placed products'
    and MACs' cotangents from the kernels' own backward passes — seeded
    with 1/M at the loss, accumulating boundary cotangents stage to stage
    and argument cotangents across microbatches, in the reference's
    order. Non-float outputs (positions, labels) get no cotangent (the
    reference's ``float0``). Microbatch means over equal slices reproduce
    the full-batch mean loss and gradients to fp32 tolerance, which is
    what lets ``Trainer(backend="pim", microbatches=M, partitions=K)``
    match the plain step. On a ring of streams its forward and backward
    cells run on the stages' streams, ordered by events as the
    asynchronous driver's are (``_Order``), bit for bit the same loss and
    gradients.

Spans go on the ``pipeline`` lane (``{phase}:tick``, ``:fwd``, ``:bwd``;
the asynchronous driver's on ``pipeline:stage{s}``) when a tracer is
enabled, synced inside so that they cover the device work: enable tracing
to attribute time, disable it to measure overlap.

"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import _tree, obs


def pipeline_forward(x: torch.Tensor, stage_params, stage_fn, *, group,
                     n_stages: int, n_micro: int) -> torch.Tensor:
    """Run this rank's stage of the GPipe grid. x: [n_micro, mb, ...], the
    same on every rank of ``group`` (the pipe axis, its ranks in stage
    order); stage_params: this rank's stage slice. Returns the last
    stage's outputs [n_micro, mb, ...] on every rank of the group.

    stage_fn(stage_params, x_mb) -> y_mb applies this stage's layers
    (outputs shaped and typed as its inputs)."""
    stage = dist.get_rank(group)
    peer = lambda s: dist.get_global_rank(group, s)     # noqa: E731
    mb_shape = x.shape[1:]
    inflight = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
    outputs = torch.zeros((n_micro,) + mb_shape, dtype=x.dtype,
                          device=x.device)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t; the others take the handed-on one
        cur_in = x[min(max(t, 0), n_micro - 1)] if stage == 0 else inflight
        if 0 <= t - stage < n_micro:
            out = stage_fn(stage_params, cur_in)
        else:                      # outside the grid: a masked zero
            out = torch.zeros_like(cur_in)
        # pass activations downstream (stage s -> s+1)
        ops = []
        if stage + 1 < n_stages:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  peer(stage + 1), group))
        if stage > 0:
            inflight = torch.empty_like(inflight)
            ops.append(dist.P2POp(dist.irecv, inflight, peer(stage - 1),
                                  group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # the last stage records its finished microbatch
        if stage == n_stages - 1 and 0 <= t - stage < n_micro:
            outputs[t - stage] = out
    # every stage gets the last stage's outputs: a SUM of the masked
    # value is a broadcast (the reference's psum; a send cannot fan out)
    outputs = outputs * float(stage == n_stages - 1)
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs


def make_pipelined_fn(stage_fn, mesh, *, axis: str = "pod",
                      n_micro: int = 4):
    """Wrap ``stage_fn`` into a pipelined callable over ``mesh``'s
    ``axis`` (a ``DeviceMesh``; the other axes hold independent
    replicas of the pipeline).

    Inputs: x [n_micro, mb, ...] and the stacked stage params [P, ...]
    (a tree), whole on every rank, or DTensors sharded on their leading
    dim over ``axis``; each rank runs the stage at its coordinate."""
    from torch.distributed.tensor import DTensor

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)

    def stage_slice(a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return a[dist.get_rank(group)]

    def fn(x, params):
        stage_params = _tree.tree_map(stage_slice, params)
        return pipeline_forward(x, stage_params, stage_fn, group=group,
                                n_stages=n_stages, n_micro=n_micro)

    return fn


def gpipe_grid(n_stages: int, n_micro: int):
    """Yield ``(tick, stage, microbatch)`` in GPipe fill-drain order."""
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                yield t, s, m


def _resolve(ref, flat_args, stage_outs):
    if ref[0] == "arg":
        return flat_args[ref[1]]
    if ref[0] == "stage":
        return stage_outs[ref[1]][ref[2]]
    return ref[1]                              # ("lit", val)


def tick_phase(t: int, n_stages: int, n_micro: int) -> str:
    """GPipe phase of tick ``t``: 'fill' while the first microbatch has
    not reached the last stage, 'drain' once the last microbatch has been
    injected, 'steady' between (fill wins the n_micro < n_stages
    overlap)."""
    if t < n_stages - 1:
        return "fill"
    if t >= n_micro:
        return "drain"
    return "steady"


def _on_cuda(values) -> bool:
    """Whether ``values`` hold a CUDA tensor: a cell span over them waits
    for the device (``_sync``), which its ``sync`` argument records."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in values)


def _sync(values) -> None:
    """Wait for the device work behind ``values`` (a span's end)."""
    for x in values:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


class _Order:
    """The events that order a grid's cells across streams. ``after(stream,
    xs)`` makes ``stream`` wait (once per event) for the event recorded
    where each tensor of ``xs`` was made, and records the tensor on
    ``stream`` so that the caching allocator keeps its memory until the
    stream has passed its readers; ``made(stream, xs)`` records one event
    on ``stream`` after the tensors ``xs`` were made there. Inert when no
    stage has a stream (the CPU, or a program compiled without a ring):
    every cell then runs on the caller's stream."""

    def __init__(self, stages: Sequence, flat_args_per_mb: Sequence):
        self.on = any(getattr(st, "stream", None) is not None
                      for st in stages)
        self.ready: dict[int, Any] = {}      # id of a tensor -> its event
        self.events: list = []               # alive, so their ids stay theirs
        self.waited: set = set()
        self.main = torch.cuda.current_stream() if self.on else None
        if self.on:                          # the arguments, made on main
            self.made(self.main, [x for flat in flat_args_per_mb
                                  for x in flat])

    def stream_of(self, stage):
        return getattr(stage, "stream", None) or self.main

    def on_stream(self, stage):
        """The context that queues a cell of ``stage`` on its stream."""
        if not self.on:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream_of(stage))

    def after(self, stream, xs) -> None:
        if not self.on:
            return
        for x in xs:
            if not isinstance(x, torch.Tensor) or not x.is_cuda:
                continue
            ev = self.ready.get(id(x))
            if ev is not None and (id(stream), id(ev)) not in self.waited:
                stream.wait_event(ev)
                self.waited.add((id(stream), id(ev)))
            x.record_stream(stream)

    def made(self, stream, xs) -> None:
        if not self.on:
            return
        ev = stream.record_event()
        self.events.append(ev)
        self.ready.update((id(x), ev) for x in xs
                          if isinstance(x, torch.Tensor))


def _stage_put(stage, ins, order: _Order, *, tick=None, micro=None) -> None:
    """Commit a stage's inputs to its stream (the reference's
    ``device_put`` onto the stage's pinned device): the stream waits for
    the events of the inputs' producers and holds each input for the
    caching allocator (``_Order.after``). Nothing blocks the host; a
    tracer records the hand-off as an instant."""
    order.after(order.stream_of(stage), ins)
    tr = obs.tracer()
    if tr.enabled and getattr(stage, "stream", None) is not None:
        tr.instant("transfer", lane="pipeline", stream=id(stage.stream),
                   tick=tick, micro=micro)


def run_partitioned(stages: Sequence, out_refs: Sequence,
                    flat_args_per_mb: Sequence[Sequence]) -> list[list]:
    """Stream M microbatches through the partition stage programs in GPipe
    fill-drain order on the caller's stream; returns each microbatch's
    flat outputs.

    ``stages`` are ``StageProgram``-shaped objects (``fn``, ``in_refs``);
    ``flat_args_per_mb[m]`` is microbatch m's flat argument list (from
    ``PartitionedProgram.flatten_args``). Microbatches are independent
    activation sets, so the interleaving cannot change numerics — each
    output equals the stages composed sequentially on that microbatch.
    A microbatch's stage outputs are dropped once its last stage has run.
    """
    n_micro = len(flat_args_per_mb)
    n_stages = len(stages)
    outs = [[None] * n_stages for _ in range(n_micro)]
    results: list = [None] * n_micro
    tr = obs.tracer()
    for t, s, m in gpipe_grid(n_stages, n_micro):
        ins = [_resolve(r, flat_args_per_mb[m], outs[m])
               for r in stages[s].in_refs]
        if tr.enabled:
            with tr.span(f"{tick_phase(t, n_stages, n_micro)}:tick",
                         lane="pipeline", tick=t, stage=s, micro=m,
                         sync=_on_cuda(ins)):
                outs[m][s] = stages[s].fn(*ins)
                _sync(outs[m][s])
        else:
            outs[m][s] = stages[s].fn(*ins)
        if s == n_stages - 1:
            results[m] = [_resolve(r, flat_args_per_mb[m], outs[m])
                          for r in out_refs]
            outs[m] = None
    return results


def run_partitioned_async(stages: Sequence, out_refs: Sequence,
                          flat_args_per_mb: Sequence[Sequence]
                          ) -> list[list]:
    """The GPipe grid with each stage on its own stream (module
    docstring).

    Same grid, same dataflow, same numerics as :func:`run_partitioned` —
    the difference is only *where* each cell is queued: on its stage's
    stream, ordered after its inputs' producers by events, so stages of
    different microbatches overlap on the card. The outputs are handed
    back ready on the caller's stream; the host never waits. With a
    tracer enabled each cell is a span on ``pipeline:stage{s}`` synced
    inside — faithful per-cell occupancy, but the measurement itself
    serializes the streams.
    """
    order = _Order(stages, flat_args_per_mb)
    if not order.on:
        return run_partitioned(stages, out_refs, flat_args_per_mb)
    n_micro = len(flat_args_per_mb)
    n_stages = len(stages)
    outs = [[None] * n_stages for _ in range(n_micro)]
    results: list = [None] * n_micro
    tr = obs.tracer()
    for t, s, m in gpipe_grid(n_stages, n_micro):
        st = stages[s]
        ins = [_resolve(r, flat_args_per_mb[m], outs[m])
               for r in st.in_refs]
        with order.on_stream(st):
            _stage_put(st, ins, order, tick=t, micro=m)
            if tr.enabled:
                with tr.span(f"{tick_phase(t, n_stages, n_micro)}:tick",
                             lane=f"pipeline:stage{s}", tick=t, stage=s,
                             micro=m, sync=_on_cuda(ins)):
                    outs[m][s] = st.fn(*ins)
                    _sync(outs[m][s])
            else:
                outs[m][s] = st.fn(*ins)
            order.made(order.stream_of(st), outs[m][s])
        if s == n_stages - 1:
            # hand microbatch m back on the caller's stream
            row = [_resolve(r, flat_args_per_mb[m], outs[m])
                   for r in out_refs]
            order.after(order.main, row)
            results[m] = row
            outs[m] = None
    return results


def _launch_counts() -> dict[str, int]:
    """The PIM kernels' launch counters (K1, K2, K3, K5), as their
    wrappers count them: launches of the kernels on the card."""
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    return {"K1": pm.pim_matmul_grouped.launches,
            "K2": pm.pim_matmul.launches, "K3": pm.pim_mac.launches,
            "K5": pm.pim_matmul_grouped_q.launches}


def _tally(stats, phase: str, s: int, before: dict) -> None:
    if stats is None:
        return
    row = stats.setdefault(phase, {}).setdefault(s, {})
    for k, v in _launch_counts().items():
        row[k] = row.get(k, 0) + v - before[k]


def _acc(a, b):
    if b is None:
        return a
    return b if a is None else a + b


def gpipe_value_and_grad(stages: Sequence, loss_ref: tuple,
                         flat_args_per_mb: Sequence[Sequence],
                         grad_argnums: Sequence[int],
                         stats: dict | None = None):
    """GPipe forward/backward over partition stage programs (module
    docstring).

    Returns ``(mean_loss, grads)`` where ``grads[i]`` is the cotangent
    sum for flat argument ``grad_argnums[i]`` — the gradient of the
    microbatch-mean loss, which for an equal split of a mean loss matches
    the full-batch gradient to fp32 tolerance. Stages with a stream
    (``compile_partitioned(..., streams=...)``) run their forward and
    backward cells there, each ordered after the producers of what it
    reads by events, as :func:`run_partitioned_async` orders its cells
    (autograd runs a stage's backward on the stream of its forward); the
    loss and the gradients come back ready on the caller's stream, with
    no host sync, and bit for bit those of the caller's stream alone.
    ``stats``, when given, is filled with each stage's kernel launches:
    ``stats["fwd"][s]`` and ``stats["bwd"][s]``, by kernel
    (``_launch_counts``), summed over the microbatches.
    """
    if loss_ref[0] != "stage":
        raise ValueError(f"loss does not depend on any stage: {loss_ref}")
    n_micro = len(flat_args_per_mb)
    n_stages = len(stages)
    wanted = set(grad_argnums)
    grid = list(gpipe_grid(n_stages, n_micro))
    outs = [[None] * n_stages for _ in range(n_micro)]
    ins_of = [[None] * n_stages for _ in range(n_micro)]
    order = _Order(stages, flat_args_per_mb)
    tr = obs.tracer()
    for t, s, m in grid:
        st = stages[s]
        raw = [_resolve(r, flat_args_per_mb[m], outs[m])
               for r in st.in_refs]
        before = _launch_counts()
        with order.on_stream(st):
            _stage_put(st, raw, order, tick=t, micro=m)
            ins = [x.detach().requires_grad_(True)
                   if (isinstance(x, torch.Tensor) and x.is_floating_point()
                       and (r[0] == "stage" or r[1] in wanted)) else x
                   for r, x in zip(st.in_refs, raw)]
            ins_of[m][s] = ins
            with torch.enable_grad():
                if tr.enabled:
                    with tr.span(f"{tick_phase(t, n_stages, n_micro)}:fwd",
                                 lane="pipeline", tick=t, stage=s, micro=m,
                                 sync=_on_cuda(ins)):
                        outs[m][s] = st.fn(*ins)
                        _sync(outs[m][s])
                else:
                    outs[m][s] = st.fn(*ins)
            order.made(order.stream_of(st), outs[m][s])
        _tally(stats, "fwd", s, before)

    ls, lj = loss_ref[1], loss_ref[2]
    losses = [outs[m][ls][lj] for m in range(n_micro)]
    order.after(order.main, losses)
    mean_loss = sum(loss.detach() for loss in losses) / n_micro

    # out_cots[m][s][j]: cotangent for stage s's j-th output, microbatch m
    out_cots = [[[None] * len(outs[m][s]) for s in range(n_stages)]
                for m in range(n_micro)]
    for m in range(n_micro):
        seed = torch.ones_like(losses[m]) / n_micro
        out_cots[m][ls][lj] = _acc(out_cots[m][ls][lj], seed)
        order.made(order.main, [out_cots[m][ls][lj]])
    grads: dict[int, Any] = {i: None for i in grad_argnums}
    for t, s, m in reversed(grid):
        st = stages[s]
        pairs = [(o, c) for o, c in zip(outs[m][s], out_cots[m][s])
                 if c is not None and isinstance(o, torch.Tensor)
                 and o.requires_grad]
        wrt = [(r, x) for r, x in zip(st.in_refs, ins_of[m][s])
               if isinstance(x, torch.Tensor) and x.requires_grad]
        before = _launch_counts()
        with order.on_stream(st):
            stream = order.stream_of(st)
            order.after(stream, [c for _, c in pairs])
            if pairs and wrt:
                def pull():
                    return torch.autograd.grad(
                        [o for o, _ in pairs], [x for _, x in wrt],
                        [c for _, c in pairs], allow_unused=True)
                if tr.enabled:
                    with tr.span(f"{tick_phase(t, n_stages, n_micro)}:bwd",
                                 lane="pipeline", tick=t, stage=s, micro=m,
                                 sync=_on_cuda(c for _, c in pairs)):
                        in_cots = pull()
                        _sync(in_cots)
                else:
                    in_cots = pull()
            else:
                in_cots = [None] * len(wrt)
            made = []
            for (ref, _), c in zip(wrt, in_cots):
                if ref[0] == "stage":
                    _, r, j = ref
                    order.after(stream, [out_cots[m][r][j]])
                    out_cots[m][r][j] = _acc(out_cots[m][r][j], c)
                    made.append(out_cots[m][r][j])
                elif ref[0] == "arg" and ref[1] in grads:
                    order.after(stream, [grads[ref[1]]])
                    grads[ref[1]] = _acc(grads[ref[1]], c)
                    made.append(grads[ref[1]])
            order.made(stream, made)
        _tally(stats, "bwd", s, before)
        outs[m][s] = ins_of[m][s] = None
    order.after(order.main, list(grads.values()))
    grad_list = [grads[i] if grads[i] is not None
                 else torch.zeros_like(flat_args_per_mb[0][i])
                 for i in grad_argnums]
    return mean_loss, grad_list
