"""llama4-maverick-400b-a17b's train step schedules (port queue item
5.3b) against the reference's planning, node for node, as
``tests/test_torch_moe_train_schedules.py`` holds granite-moe-1b-a400m's:
units of a dense block then an MoE block with the shared expert, each
unit one iteration of the layer stack and of its transpose (each block's
rope tables and the slot map's group offsets hoisted out of the stack,
as the reference's linearization hoists them). Rows: the smoke config
(one unit), at 4 layers (two units, so the stack folds with repeat 2),
with remat, and with ``grad_accum=2`` (the stack inside the microbatch
scan). The published width at one unit in float32 (843,378 subarrays)
is held by ``scripts/check_long_schedules.py``
(``maverick_train_128_1_unit``), as the suite's time allows.
"""

import pytest

from test_torch_moe_train_schedules import assert_train_schedule

# (name, config changes, batch, seq, nodes, subarrays, nodes by repeat,
# eltwise nodes outside the folded loops)
MAVERICK_ROWS = [
    ("smoke", dict(), 1, 8, 615, 211, {1: 615}, 382),
    ("smoke_4_layers", dict(n_layers=4), 1, 8, 615, 211,
     {1: 395, 2: 220}, 382),
    ("smoke_4_layers_remat", dict(n_layers=4, remat=True), 1, 8, 713, 261,
     {1: 395, 2: 318}, 382),
    ("smoke_accum", dict(grad_accum=2), 1, 8, 667, 211, {1: 379, 2: 288},
     379),
]


@pytest.mark.parametrize("name,changes,batch,seq,n_nodes,subarrays,"
                         "repeats,outside", MAVERICK_ROWS,
                         ids=[r[0] for r in MAVERICK_ROWS])
def test_maverick_train_schedule_equals_reference(name, changes, batch,
                                                  seq, n_nodes, subarrays,
                                                  repeats, outside):
    assert_train_schedule("llama4-maverick-400b-a17b", name, changes, batch,
                          seq, n_nodes, subarrays, repeats, outside)
