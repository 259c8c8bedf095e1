"""Checkpoints in the reference's on-disk format: numpy leaves and a JSON
manifest (``io``), and a keep-last-k manager (``manager``)."""
from repro_torch.checkpoint.io import (load_manifest, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "load_manifest", "restore_checkpoint",
           "save_checkpoint"]
