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
    program with one grouped launch per placed node (K1 and K3).

The aggregate estimator (``repro_torch.core.estimator``) remains the ideal
zero-stall bound; ``Schedule.reconcile()`` proves each schedule against it.

Ported so far: the serve (forward) path of the paper's LeNet
(``map_lenet`` / ``compile_lenet``). Not yet (ROADMAP.md, queue item 3):
training, pipeline partitions, scan expansion, quantized weight and
activation grids, paged-KV placement, and ``map_arch`` / ``compile_arch``.
"""

from repro_torch.mapper.api import (abstract_like, compile_arch,
                                    compile_lenet, map_arch, map_lenet)
from repro_torch.mapper.compile import (CompiledProgram, clear_program_cache,
                                        compile_schedule,
                                        program_cache_stats)
from repro_torch.mapper.executor import ScheduleExecutor, run_schedule
from repro_torch.mapper.graph import (ConvNode, EltwiseNode, MatmulNode,
                                      OpGraph, OpNode, build_graph)
from repro_torch.mapper.hardware import (ChipSpec, PIMHierarchy,
                                         SubarraySpec, TileSpec,
                                         curve_candidates, default_hierarchy,
                                         make_subarray, tile_curve)
from repro_torch.mapper.lowering import LoweringContext, eval_placed
from repro_torch.mapper.placement import (NodePlacement, PlacedBlock,
                                          Placement, PlacementPolicy,
                                          node_homes, place,
                                          total_transfer_hops)
from repro_torch.mapper.schedule import (Schedule, ScheduleReport, StageCost,
                                         build_schedule,
                                         build_schedule_from_graph)

__all__ = [
    "ChipSpec", "CompiledProgram", "ConvNode", "EltwiseNode",
    "LoweringContext", "MatmulNode", "NodePlacement", "OpGraph", "OpNode",
    "PIMHierarchy", "PlacedBlock", "Placement", "PlacementPolicy",
    "Schedule", "ScheduleExecutor", "ScheduleReport", "StageCost",
    "SubarraySpec", "TileSpec", "abstract_like", "build_graph",
    "build_schedule", "build_schedule_from_graph", "clear_program_cache",
    "compile_arch", "compile_lenet", "compile_schedule", "curve_candidates",
    "default_hierarchy", "eval_placed", "make_subarray", "map_arch",
    "map_lenet", "node_homes", "place", "program_cache_stats",
    "run_schedule", "tile_curve", "total_transfer_hops",
]
