"""The train step of qwen2.5-32b at its published depth and width (64
layers, 5120 wide, ``grad_accum=2``: the batch of 1 rounded to 2), seq
8, in the port against the reference's planning node for node (kind,
shape, MACs, edges, ``repeat``, names), with the subarrays, the placement
node by node, the report and ``reconcile()``: the row the reference's
own ``test_full_arch_schedules_reconcile`` maps. The oracle is
``test_torch_long_schedules._oracle`` (the reference's planning less its
equations with no outputs). The port traces every layer of both
microbatches on meta tensors, about a minute on one CPU core, so
qwen3-32b's row is a file of its own
(``tests/test_torch_variant_depth_qwen3.py``) that another worker can
take; the other schedules of the variants are
``tests/test_torch_variant_schedules.py``'s.
"""

from repro.configs import get_config as ref_config
from repro_torch import mapper
from test_torch_arch_train import _assert_schedules_equal
from test_torch_long_schedules import _oracle


def check_published_train(arch: str, n_nodes: int, subarrays: int,
                          folded: int) -> None:
    port = mapper.map_arch(arch, "train", batch=1, seq_len=8)
    _assert_schedules_equal(port, _oracle(ref_config(arch), 1, 8), n_nodes,
                            subarrays)
    # the nodes of the stack and its transpose, folded inside the
    # microbatch scan: repeat 2 x 64
    assert [nd.repeat for nd in port.graph.nodes].count(128) == folded


def test_qwen2_5_published_train_schedule_equals_reference():
    check_published_train("qwen2.5-32b", 415, 138_236, 135)
