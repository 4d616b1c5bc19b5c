"""Inference-only evaluation, the 03_ML_Testing.ipynb flow, on the port
(``examples/03_testing.py`` is the JAX package's).

Build a test loader -> load the saved model -> a Trainer with no
datasets (the reference's "Testing only" path) -> ``trainer.test``,
returning (loss, metric).  The checkpoint is MODEL_DIR's ``model.pth``
or a ``.pth`` given as the first argument: the reference's layout, as
the reference, the JAX package's ``export_torch`` and the port's
``save_model`` and ``export_torch`` write it (DDP's ``module.`` prefix
is stripped).

    python examples/torch_port/03_testing.py [model.pth]          # card
    BACKEND=cpu python examples/torch_port/03_testing.py [model.pth]
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os
import sys

from ml_trainer_tpu_torch import Loader, MLModel, Trainer, load_model
from ml_trainer_tpu_torch.data import CIFAR10, SyntheticCIFAR10
from ml_trainer_tpu_torch.utils import custom_pre_process_function

MODEL_DIR = os.environ.get("MODEL_DIR", "model_output")
DATA_DIR = os.environ.get("DATA_DIR", "data")
DEVICE = _bootstrap.device()


def main():
    transform = custom_pre_process_function()
    try:
        val_set = CIFAR10(DATA_DIR, train=False, transform=transform)
    except FileNotFoundError:
        val_set = SyntheticCIFAR10(size=512, transform=transform, seed=1)
    test_loader = Loader(val_set, batch_size=32, shuffle=True)

    checkpoint = sys.argv[1] if len(sys.argv) > 1 else MODEL_DIR
    model = load_model(MLModel(device=DEVICE), checkpoint)

    trainer = Trainer(MLModel(device=DEVICE), device=DEVICE)  # no datasets
    test_loss, test_metric = trainer.test(model, test_loader)
    print(f"loss {test_loss:.4f}  accuracy {test_metric:.4f}")
    return model, test_loss, test_metric


if __name__ == "__main__":
    main()
