"""Full-state checkpoints (format v2, the JAX package's layout):
``checkpoint.py``; the reference's ``model.pth`` export:
``torch_export.py``."""

from ml_trainer_tpu_torch.checkpoint.checkpoint import (
    CHECKPOINT_PREFIX,
    CORRUPT_SUFFIX,
    CheckpointCorrupt,
    checkpoint_format,
    latest_checkpoint,
    latest_valid_checkpoint,
    prune_checkpoints,
    quarantine_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
    wait_for_checkpoints,
    weights_fingerprint,
    weights_structure_digest,
)
from ml_trainer_tpu_torch.checkpoint.torch_export import (
    convert_to_torch_state_dict,
    save_torch_checkpoint,
)

__all__ = [
    "CHECKPOINT_PREFIX", "CORRUPT_SUFFIX", "CheckpointCorrupt",
    "checkpoint_format", "convert_to_torch_state_dict", "latest_checkpoint",
    "latest_valid_checkpoint", "prune_checkpoints", "quarantine_checkpoint",
    "restore_checkpoint", "save_checkpoint", "save_torch_checkpoint",
    "verify_checkpoint", "wait_for_checkpoints", "weights_fingerprint",
    "weights_structure_digest",
]
