"""PIM mapper & schedule subsystem of the port (``repro.mapper``'s
counterpart).

Compiles a PyTorch function onto an explicit chip -> tile -> subarray
hierarchy of the paper's SOT-MRAM PIM arrays:

    aten graph (make_fx, shapes only) --(graph)--> operator graph
    --(placement)--> weight-stationary subarray blocks with explicit
    (chip, tile, subarray) coordinates along a locality-preserving tile
    curve --(schedule)--> cost-rolled static schedule
    --(executor | compile)--> numerical execution with the port's PIM
    kernels: the per-block walk (the oracle, K2 and K3) or a compiled
    program with one grouped launch per placed node (K1 and K3; K5 over
    a quantized weight grid).

The aggregate estimator (``repro_torch.core.estimator``) remains the ideal
zero-stall bound; ``Schedule.reconcile()`` proves each schedule against it.

Ported so far: the paper's LeNet, its forward pass and its training step
(``map_lenet`` / ``compile_lenet``, ``kind="serve"`` or ``"train"``, and
any step ``build_schedule`` is given, such as the trainer's AdamW step),
on the fp32 grid or a quantized weight grid (``weight_dtype``, with
``act_dtype`` and ``ideal_provision``); a compiled program and the
per-block executor are differentiable; a registered architecture's
decode and train steps (``map_arch`` / ``compile_arch``), the layer stack
folded into the reference's scanned nodes; and pipeline partitions
(``partition``, ``Schedule.pipeline``, ``compile_partitioned``, driven by
``repro_torch.parallel.pipeline``) with scan expansion
(``expand_graph``), so the cuts can land inside a layer stack; and a
paged KV pool placed next to its attention consumers (``place_kv``) with
its per-step traffic priced into the schedule (``Schedule.attach_kv``).
"""

from repro_torch.mapper.api import (abstract_like, compile_arch,
                                    compile_lenet, map_arch, map_lenet)
from repro_torch.mapper.compile import (CompiledProgram, PartitionedProgram,
                                        StageProgram, clear_program_cache,
                                        compile_partitioned,
                                        compile_schedule,
                                        program_cache_stats)
from repro_torch.mapper.executor import ScheduleExecutor, run_schedule
from repro_torch.mapper.graph import (ConvNode, EltwiseNode, MatmulNode,
                                      OpGraph, OpNode, Unit, build_graph,
                                      expand_graph, plan_scan_expansion,
                                      scan_lengths)
from repro_torch.mapper.hardware import (ChipSpec, PIMHierarchy,
                                         SubarraySpec, TileSpec,
                                         curve_candidates, default_hierarchy,
                                         make_subarray, tile_curve)
from repro_torch.mapper.lowering import LoweringContext, eval_placed
from repro_torch.mapper.placement import (GraphPartition, KVBlockSpec,
                                          KVPlacement, NodePlacement,
                                          PlacedBlock, Placement,
                                          PlacementPolicy, node_homes,
                                          partition, place, place_kv,
                                          total_transfer_hops)
from repro_torch.mapper.schedule import (EXPAND_BUDGET_CHIPS, KVTraffic,
                                         PartitionCost,
                                         PipelineTimeline, Schedule,
                                         ScheduleReport, StageCost,
                                         build_schedule,
                                         build_schedule_from_graph)

__all__ = [
    "ChipSpec", "CompiledProgram", "ConvNode", "EXPAND_BUDGET_CHIPS",
    "EltwiseNode", "GraphPartition", "KVBlockSpec", "KVPlacement",
    "KVTraffic", "LoweringContext", "MatmulNode", "NodePlacement",
    "OpGraph", "OpNode", "PIMHierarchy", "PartitionCost",
    "PartitionedProgram", "PipelineTimeline", "PlacedBlock", "Placement",
    "PlacementPolicy", "Schedule", "ScheduleExecutor", "ScheduleReport",
    "StageCost", "StageProgram", "SubarraySpec", "TileSpec", "Unit",
    "abstract_like", "build_graph", "build_schedule",
    "build_schedule_from_graph", "clear_program_cache", "compile_arch",
    "compile_lenet", "compile_partitioned", "compile_schedule",
    "curve_candidates", "default_hierarchy", "eval_placed", "expand_graph",
    "make_subarray", "map_arch", "map_lenet", "node_homes", "partition",
    "place", "place_kv", "plan_scan_expansion", "program_cache_stats",
    "run_schedule", "scan_lengths", "tile_curve", "total_transfer_hops",
]
