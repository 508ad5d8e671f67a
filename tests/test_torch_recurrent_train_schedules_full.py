"""The recurrent train step's schedules at the published width (port
queue item 5.4b), traced on meta tensors, against the reference's
planning node for node (``test_torch_recurrent_train_schedules.py`` has
the smoke rows and the method): xlstm-350m
cut to 4 layers in float32 at batch 1, seq 512 (the chip script's hold
of ``recurrent_train``) and as published (24 layers, bf16, remat) at
seq 16; zamba2-7b's are in
``tests/test_torch_recurrent_train_schedules_full_zamba2.py``.

A loop of the recurrent stack (``models.lin``: ``Tape.loop`` and
``Tape.checkpoint_loop``) traces its first iteration under ``make_fx``
and copies its nodes for the others, and its transpose traces the last
and copies it (``lin.COPY_TRACED_ITERATIONS``): xlstm's 512 sLSTM tokens
in each unit and its transpose, zamba2's 13 groups. The graph so built
is the one tracing every iteration gives, node for node (ops, arguments,
values, regions), on smoke rows with and without remat (zamba2's in the
other file).
"""

import dataclasses

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import estimator
from repro_torch.launch import steps
from repro_torch.models import lin
from test_torch_long_schedules import _graph_rows
from test_torch_moe_train_schedules import assert_train_schedule

# (name, arch, config changes, batch, seq, nodes, subarrays, nodes by
# repeat, eltwise nodes outside the folded loops)
ROWS = [
    ("full_width_4_layers", "xlstm-350m", dict(n_layers=4,
                                               dtype="float32"), 1, 512,
     754, 30_373, {1: 340, 2: 163, 4: 205, 1024: 46}, 327),
    ("published", "xlstm-350m", dict(), 1, 16, 710, 14_443,
     {1: 340, 12: 324, 192: 46}, 327),
]


@pytest.mark.parametrize("name,arch,changes,batch,seq,n_nodes,subarrays,"
                         "repeats,outside", ROWS,
                         ids=[f"{r[1].split('-')[0]}-{r[0]}" for r in ROWS])
def test_published_width_train_schedule_equals_reference(
        name, arch, changes, batch, seq, n_nodes, subarrays, repeats,
        outside):
    assert_train_schedule(arch, name, changes, batch, seq, n_nodes,
                          subarrays, repeats, outside)


@pytest.mark.parametrize("arch,changes,batch,seq", [
    ("xlstm-350m", dict(), 2, 16), ("xlstm-350m", dict(remat=True), 2, 16)],
    ids=["xlstm", "xlstm-remat"])
def test_copied_iterations_are_the_traced_graph(monkeypatch, arch, changes,
                                                batch, seq):
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    p = steps.abstract_params(cfg)
    args = (steps.make_train_step(cfg), p, steps.abstract_opt_state(cfg, p),
            steps.input_specs(cfg, ShapeSpec("m", seq, batch, "train")))
    copied = estimator.capture(*args).gm
    monkeypatch.setattr(lin, "COPY_TRACED_ITERATIONS", False)
    traced = estimator.capture(*args).gm
    assert _graph_rows(copied) == _graph_rows(traced)
