"""Step functions and their abstract inputs: the port of
``repro.launch.steps``."""

from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, decode_input_specs,
                                      input_specs, make_loss_fn,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, token_xent)

__all__ = ["abstract_cache", "abstract_opt_state", "abstract_params",
           "decode_input_specs", "input_specs", "make_loss_fn",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "token_xent"]
