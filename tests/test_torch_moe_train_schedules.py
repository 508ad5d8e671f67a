"""The mixture-of-experts train step's schedules (port queue item 5.3b)
in the port against the reference's planning, node for node (kind,
shape, MACs, edges, ``repeat``, names), with the subarrays, the
placement node by node, the report and ``reconcile()``:
``map_arch(kind="train")`` of granite-moe-1b-a400m (an MoE block every
layer) at its smoke config (seq 8, with remat, and at seq 2560 with the
chunked attention, with and without remat) and at its published width
cut to 2 layers in float32 (seq 128, remat as published). The MoE
block's linearized forward, its written-out transpose and the units of
llama4-maverick-400b-a17b are held in
``tests/test_torch_moe_train_schedules_maverick.py``.

The oracle is the reference's own planning of its traced step less its
equations with no outputs (``test_torch_long_schedules._oracle``; its
``map_arch(kind="train")`` raises under jax 0.9.0). The published config
at full depth (24 layers, bf16) traces for ~20 s on the CPU:
``scripts/check_long_schedules.py`` holds it (``granite_train_128``).
"""

import collections
import dataclasses

import pytest

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro_torch import mapper
from repro_torch.configs import get_config, get_smoke_config
from test_torch_arch_train import _assert_schedules_equal
from test_torch_long_schedules import _oracle

# (name, config changes, batch, seq, nodes, subarrays, nodes by repeat,
# eltwise nodes outside the folded loops)
GRANITE_ROWS = [
    ("smoke", dict(), 1, 8, 324, 123, {1: 207, 2: 117}, 194),
    ("smoke_remat", dict(remat=True), 1, 8, 378, 151, {1: 207, 2: 171},
     194),
    ("smoke_2560", dict(), 1, 2560, 375, 1_527,
     {1: 194, 2: 106, 5: 13, 30: 62}, 194),
    ("smoke_2560_remat", dict(remat=True), 1, 2560, 448, 2_275,
     {1: 194, 2: 156, 5: 13, 30: 85}, 194),
    ("full_width_2_layers", dict(n_layers=2, dtype="float32"), 1, 128, 378,
     18_729, {1: 207, 2: 171}, 194),
]


def assert_train_schedule(arch, name, changes, batch, seq, n_nodes,
                          subarrays, repeats, outside):
    """``map_arch(arch, "train")`` of the smoke or published config with
    ``changes`` equal to the reference's planning (module docstring)."""
    base_ref, base = ((ref_smoke_config, get_smoke_config)
                      if name.startswith("smoke")
                      else (ref_config, get_config))
    rcfg = dataclasses.replace(base_ref(arch), **changes)
    cfg = dataclasses.replace(base(arch), **changes)
    port = mapper.map_arch(arch, "train", batch=batch, seq_len=seq,
                           config=cfg)
    _assert_schedules_equal(port, _oracle(rcfg, batch, seq), n_nodes,
                            subarrays)
    nodes = port.graph.nodes
    assert dict(collections.Counter(nd.repeat for nd in nodes)) == repeats
    # every product lies in a folded loop: the layer stack, its transpose,
    # the pair scan or the cross-entropy's chunk loops
    assert all(nd.scanned for nd in nodes if nd.kind == "matmul")
    assert sum(nd.kind == "eltwise" and not nd.scanned
               for nd in nodes) == outside


@pytest.mark.parametrize("name,changes,batch,seq,n_nodes,subarrays,"
                         "repeats,outside", GRANITE_ROWS,
                         ids=[r[0] for r in GRANITE_ROWS])
def test_granite_train_schedule_equals_reference(name, changes, batch, seq,
                                                 n_nodes, subarrays,
                                                 repeats, outside):
    assert_train_schedule("granite-moe-1b-a400m", name, changes, batch, seq,
                          n_nodes, subarrays, repeats, outside)
