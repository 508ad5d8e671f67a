"""The port's synthetic token stream against the reference's.

``repro_torch.data.TokenStream`` is a numpy copy of the reference's
``repro.data.pipeline.TokenStream``: for the same (vocab, seq, batch,
seed, host rank) every batch is the reference's, bit for bit, and a pure
function of its step.
"""

import numpy as np
import pytest

from repro.data.pipeline import TokenStream as RefTokenStream
from repro_torch.data import TokenStream


@pytest.mark.parametrize("vocab,seq,batch,seed,rank", [
    (256, 16, 2, 0, 0), (128_256, 128, 1, 0, 0), (1000, 33, 3, 7, 2)])
def test_batches_equal_the_reference_bit_for_bit(vocab, seq, batch, seed,
                                                 rank):
    ref = RefTokenStream(vocab, seq, batch, seed=seed, host_rank=rank)
    port = TokenStream(vocab, seq, batch, seed=seed, host_rank=rank)
    for step in (0, 1, 5):
        want, got = ref.batch(step), port.batch(step)
        assert list(got) == ["tokens", "labels"] == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            assert got[key].shape == (batch, seq)
            np.testing.assert_array_equal(got[key], want[key])


def test_a_batch_is_a_function_of_its_step():
    a, b = TokenStream(256, 16, 2, seed=3), TokenStream(256, 16, 2, seed=3)
    np.testing.assert_array_equal(a.batch(4)["tokens"], b.batch(4)["tokens"])
    assert not np.array_equal(a.batch(4)["tokens"], a.batch(5)["tokens"])
    # next-token labels: a batch's labels are its tokens shifted by one
    x = a.batch(0)
    np.testing.assert_array_equal(x["labels"][:, :-1], x["tokens"][:, 1:])
