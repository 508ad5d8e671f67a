"""qwen3-32b's train step at its published depth and width (64 layers,
``grad_accum=2``), seq 8, against the reference's planning node for node,
as ``tests/test_torch_variant_depth.py`` holds qwen2.5-32b's: in a file
of its own, so that the two minute-long traces can run on two workers."""

from test_torch_variant_depth import check_published_train


def test_qwen3_published_train_schedule_equals_reference():
    check_published_train("qwen3-32b", 429, 137_888, 165)
