"""repro_torch.checkpoint — step-atomic, hashed checkpoints in the JAX
package's on-disk format."""
from .ckpt import CheckpointManager, available_steps, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "available_steps", "load_checkpoint", "save_checkpoint"]
