"""The recurrent train step's schedules (port queue item 5.4b) in the
port against the reference's planning, node for node (kind, shape, MACs,
edges, ``repeat``, names), with the subarrays, the placement node by
node, the report and ``reconcile()``: ``map_arch(kind="train")`` of
xlstm-350m at its smoke config (seq 16, with remat, at seq 512 — two
mLSTM chunks and 512 sLSTM tokens — and with ``grad_accum=2``;
zamba2-7b's rows are in
``tests/test_torch_recurrent_train_schedules_zamba2.py``). The loops of
the reference fold as its scans: the units
(zamba2's groups, with the Mamba2 layers' loop inside each, and the
tail), the chunks of each mLSTM and Mamba2 block (the checkpointed body,
recomputed in its transpose), the sLSTM's tokens, the microbatches, and
their transposes; the repeats multiply.

The oracle is the reference's own planning of its traced step less its
equations with no outputs (``test_torch_long_schedules._oracle``; its
``map_arch(kind="train")`` stops at ``graph.py:145`` under jax 0.9.0).
The published width (rows 10-13) and the capture that copies a loop's
traced iteration are held in
``tests/test_torch_recurrent_train_schedules_full.py``.
"""

import pytest

from test_torch_moe_train_schedules import assert_train_schedule

# (name, arch, config changes, batch, seq, nodes, subarrays, nodes by
# repeat, eltwise nodes outside the folded loops)
ROWS = [
    ("smoke", "xlstm-350m", dict(), 2, 16, 627, 325,
     {1: 342, 2: 251, 32: 34}, 329),
    ("smoke_remat", "xlstm-350m", dict(remat=True), 2, 16, 710, 371,
     {1: 340, 2: 324, 32: 46}, 327),
    ("smoke_512", "xlstm-350m", dict(), 1, 512, 667, 1_423,
     {1: 342, 2: 122, 4: 169, 1024: 34}, 329),
    ("smoke_accum", "xlstm-350m", dict(grad_accum=2), 2, 16, 673, 207,
     {1: 334, 2: 54, 4: 251, 64: 34}, 334),
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
