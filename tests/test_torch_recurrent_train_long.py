"""The recurrent train step's gradients (port queue item 5.4b) against
``jax.grad`` of the reference's loss where the reference runs long
(``tests/test_torch_recurrent_train.py`` has the method and the other
rows):

* zamba2-7b's smoke config at seq 2560: the shared
  attention + MLP block on the chunked attention (the pair scan), the
  Mamba2 blocks over 20 chunks;
* inputs that tie: xlstm-350m at seq 512 with ``w_i`` and ``w_f`` zero
  and ``f_bias`` 200, so every ``log f`` is exactly 0: the mLSTM's
  ``cummax`` ties at every position and its ``maximum`` with the carried
  ``m`` in the second chunk, and the sLSTM's ``maximum`` at every token
  after the first. Each tie splits the cotangent in halves, as JAX's
  ``_balanced_eq`` (torch's ``cummax`` sends it to one index).
"""

import jax
import jax.numpy as jnp
import torch

from repro_torch.checkpoint import stacked_from_reference
from test_torch_recurrent_train import (XLSTM, ZAMBA2, _reference_init,
                                        assert_grads_match, configs,
                                        flat_np, reference_state,
                                        token_batch)


def test_chunked_attention_gradients_match_reference():
    rcfg, cfg, rp, tree = reference_state(ZAMBA2)
    assert_grads_match(rcfg, cfg, rp, tree, token_batch(cfg, 2, 2560))


def test_gradients_at_tied_inputs_match_reference():
    """Every ``log f`` exactly 0 (module docstring): the mLSTM's cummax
    and maxima and the sLSTM's maxima tie; JAX's halves hold."""
    rcfg, cfg = configs(XLSTM)

    def tied(path, leaf):
        key = jax.tree_util.keystr(path)
        if "'w_i'" in key or "'w_f'" in key:
            return jnp.zeros_like(leaf)
        if "'f_bias'" in key:
            return jnp.full_like(leaf, 200.0)
        return leaf

    rp = jax.tree_util.tree_map_with_path(tied, _reference_init(XLSTM))
    tree = stacked_from_reference(flat_np(rp), cfg, device="cpu")
    assert float(torch.nn.functional.softplus(torch.tensor(-200.0))) == 0.0
    assert_grads_match(rcfg, cfg, rp, tree, token_batch(cfg, 1, 512, 3))
