"""Step functions and their abstract inputs: the port of the serve parts
of ``repro.launch``."""

from repro_torch.launch.steps import (abstract_cache, abstract_params,
                                      decode_input_specs, make_serve_step)

__all__ = ["abstract_cache", "abstract_params", "decode_input_specs",
           "make_serve_step"]
