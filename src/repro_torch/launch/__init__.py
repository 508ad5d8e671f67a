"""Step functions, their abstract inputs and a cell's shardings: the port
of ``repro.launch.steps``. ``repro_torch.launch.mesh`` builds the meshes
and ``python -m repro_torch.launch.train`` is the training launcher."""

from repro_torch.launch.steps import (CellShardings, abstract_cache,
                                      abstract_opt_state, abstract_params,
                                      batch_specs, cell_shardings,
                                      decode_input_specs, input_specs,
                                      make_loss_fn, make_prefill_step,
                                      make_rules, make_serve_step,
                                      make_train_step, token_xent)

__all__ = ["CellShardings", "abstract_cache", "abstract_opt_state",
           "abstract_params", "batch_specs", "cell_shardings",
           "decode_input_specs", "input_specs", "make_loss_fn",
           "make_prefill_step", "make_rules", "make_serve_step",
           "make_train_step", "token_xent"]
