"""Parallelism of the port: the logical-axis sharding rules on DeviceMesh
and DTensor (``repro_torch.parallel.sharding``) and the GPipe pipelines
(``repro_torch.parallel.pipeline``): the mesh pipeline over a process
group's ranks and the GPipe walks over PIM partition stage programs."""

from repro_torch.parallel.sharding import (AxisRules, constrain,
                                           current_rules, logical_to_spec,
                                           param_specs, use_rules)

__all__ = ["AxisRules", "constrain", "current_rules", "logical_to_spec",
           "param_specs", "use_rules"]
