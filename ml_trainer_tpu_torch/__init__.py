"""ml_trainer_tpu_torch: the PyTorch/CUDA port of ``ml_trainer_tpu``.

The JAX package beside it stays the reference; this package imports
``torch`` and numpy only.  Its entry points (``Server``,
``SlotDecodeEngine``, ``generate``, ``Trainer``, the model constructors)
run on the CUDA card unless the caller passes ``device="cpu"``, and raise
when no card is visible.  The TPU's Pallas kernels on the serving and
training paths are hand-written CUDA kernels here (``csrc/``), built with
``nvcc`` at first use; ``launch_counts()`` shows how often each one ran.
"""

from ml_trainer_tpu_torch.convert import init_gpt2, params_from_jax
from ml_trainer_tpu_torch.data import Loader, SyntheticTokens
from ml_trainer_tpu_torch.device import (
    launch_counts,
    reset_launch_counts,
    resolve_device,
)
from ml_trainer_tpu_torch.generate import generate
from ml_trainer_tpu_torch.models import GPT2, get_model
from ml_trainer_tpu_torch.serving import Server, SlotDecodeEngine
from ml_trainer_tpu_torch.trainer import Trainer
from ml_trainer_tpu_torch.utils import load_history, load_model

__version__ = "0.1.0"

__all__ = [
    "GPT2", "Loader", "Server", "SlotDecodeEngine", "SyntheticTokens",
    "Trainer", "generate", "get_model", "init_gpt2", "launch_counts",
    "load_history", "load_model", "params_from_jax", "reset_launch_counts",
    "resolve_device",
]
