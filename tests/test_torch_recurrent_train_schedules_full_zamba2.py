"""zamba2-7b's train step schedules at the published width (port queue
item 5.4b), traced on meta tensors, against the reference's planning
node for node (``tests/test_torch_recurrent_train_schedules*.py`` have
the method): cut to 13 layers (2 groups of
6 Mamba2 layers and a tail layer) in float32 at batch 2, seq 256 (the
chip script's hold of ``recurrent_train``) and as published (81 layers,
13 groups, bf16, remat) at seq 16 — and the capture that copies a
loop's traced iteration (``lin.COPY_TRACED_ITERATIONS``) equal to
tracing every iteration, with remat at two Mamba2 chunks.
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
    ("full_width_13_layers", "zamba2-7b", dict(n_layers=13,
                                               dtype="float32"), 2, 256,
     952, 63_772, {1: 484, 2: 139, 4: 153, 24: 99, 48: 77}, 484),
    ("published", "zamba2-7b", dict(), 2, 16, 952, 56_375,
     {1: 484, 2: 62, 6: 139, 26: 91, 156: 176}, 484),
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
    ("zamba2-7b", dict(remat=True, grad_accum=1), 2, 256)],
    ids=["zamba2-remat-256"])
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
