"""zamba2-7b's train step schedules at its smoke config (port queue item
5.4b) against the reference's planning node for
node (``tests/test_torch_recurrent_train_schedules.py`` has the method):
seq 16 with its published ``grad_accum=2`` (the microbatch scan), with
remat (each group and tail layer checkpointed, and each Mamba2 layer
inside a group), with ``grad_accum=1``, at seq 256 (two Mamba2 chunks)
and at seq 2560 (the shared block's chunked attention, its pair scan
folded inside the groups).
"""

import pytest

from test_torch_moe_train_schedules import assert_train_schedule

# (name, arch, config changes, batch, seq, nodes, subarrays, nodes by
# repeat, eltwise nodes outside the folded loops)
ROWS = [
    ("smoke", "zamba2-7b", dict(), 2, 16, 824, 230,
     {1: 484, 2: 167, 4: 70, 8: 103}, 484),
    ("smoke_remat", "zamba2-7b", dict(remat=True), 2, 16, 952, 301,
     {1: 484, 2: 201, 4: 91, 8: 176}, 484),
    ("smoke_no_accum", "zamba2-7b", dict(grad_accum=1), 2, 16, 758, 298,
     {1: 585, 2: 70, 4: 103}, 469),
    ("smoke_256", "zamba2-7b", dict(), 2, 256, 824, 735,
     {1: 484, 2: 120, 4: 117, 8: 56, 16: 47}, 484),
    ("smoke_2560", "zamba2-7b", dict(), 2, 2560, 875, 1_425,
     {1: 484, 2: 107, 4: 59, 8: 56, 10: 13, 40: 47, 60: 62, 160: 47}, 484),
]


@pytest.mark.parametrize("name,arch,changes,batch,seq,n_nodes,subarrays,"
                         "repeats,outside", ROWS,
                         ids=[f"{r[1].split('-')[0]}-{r[0]}" for r in ROWS])
def test_recurrent_train_schedule_equals_reference(name, arch, changes,
                                                   batch, seq, n_nodes,
                                                   subarrays, repeats,
                                                   outside):
    assert_train_schedule(arch, name, changes, batch, seq, n_nodes,
                          subarrays, repeats, outside)
