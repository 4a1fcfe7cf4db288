"""repro_torch.train — the train loop with checkpoint/restart (the JAX
package's Trainer, on one card)."""
from .trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
