"""LeNet-type CNN of the paper's own experiments (§4.1): ~21.7k params,
trained on 28x28x1 10-class images (MNIST in the paper; a procedural
surrogate offline — see DESIGN.md §2)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet5"
    in_hw: int = 28
    conv_channels: tuple = (6, 16)
    kernel: int = 5
    fc_dims: tuple = (64, 35)
    n_classes: int = 10
    dtype: str = "float32"


CONFIG = LeNetConfig()


def smoke_config() -> LeNetConfig:
    return CONFIG  # already tiny
