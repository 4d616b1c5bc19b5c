"""Full-state checkpoints (formats 2 and 3, the JAX package's layouts)
and the export manifest (``model_manifest.json``): ``checkpoint.py``;
the reference's ``model.pth``: ``torch_export.py`` writes it,
``torch_import.py`` reads it."""

from ml_trainer_tpu_torch.checkpoint.checkpoint import (
    CHECKPOINT_PREFIX,
    CORRUPT_SUFFIX,
    CheckpointCorrupt,
    checkpoint_format,
    latest_checkpoint,
    latest_valid_checkpoint,
    load_model_manifest,
    prune_checkpoints,
    quarantine_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_sharded,
    verify_checkpoint,
    wait_for_checkpoints,
    weights_fingerprint,
    weights_structure_digest,
    write_model_manifest,
)
from ml_trainer_tpu_torch.checkpoint.torch_export import (
    convert_to_torch_state_dict,
    save_torch_checkpoint,
)
from ml_trainer_tpu_torch.checkpoint.torch_import import (
    convert_torch_state_dict,
    is_reference_layout,
)

__all__ = [
    "CHECKPOINT_PREFIX", "CORRUPT_SUFFIX", "CheckpointCorrupt",
    "checkpoint_format", "convert_to_torch_state_dict",
    "convert_torch_state_dict", "is_reference_layout", "latest_checkpoint",
    "latest_valid_checkpoint", "load_model_manifest", "prune_checkpoints", "quarantine_checkpoint",
    "restore_checkpoint", "save_checkpoint", "save_checkpoint_sharded",
    "save_torch_checkpoint",
    "verify_checkpoint", "wait_for_checkpoints", "weights_fingerprint",
    "weights_structure_digest", "write_model_manifest",
]
