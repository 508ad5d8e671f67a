"""Training of the port (``repro.train``'s counterpart)."""

from repro_torch.train.monitor import HeartbeatMonitor, StragglerPolicy
from repro_torch.train.trainer import Trainer, TrainerConfig, eval_accuracy

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "Trainer",
           "TrainerConfig", "eval_accuracy"]
