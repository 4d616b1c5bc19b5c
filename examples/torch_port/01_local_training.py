"""Local single-device training, the 01_ML_Training_local.ipynb flow, on
the port (``examples/01_local_training.py`` is the JAX package's).

The reference notebook's cells: build the datasets and the config ->
Trainer(epochs=6, batch_size=32) -> fit -> load and plot the history ->
load_model -> test.  Real CIFAR-10 when the pickle batches are under
DATA_DIR, synthetic data otherwise.

    python examples/torch_port/01_local_training.py          # on the card
    BACKEND=cpu EPOCHS=1 SYNTH_SIZE=256 \
        python examples/torch_port/01_local_training.py      # on the CPU

Knobs (env vars): EPOCHS (6), SYNTH_SIZE (2048 training images, a
quarter as many for validation), PLOT (draw plot_history), GOLDEN_OUT
(write the run's record as JSON).
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os

from ml_trainer_tpu_torch import (
    Loader,
    MLModel,
    Trainer,
    init_model,
    load_history,
    load_model,
    plot_history,
)
from ml_trainer_tpu_torch.data import CIFAR10, SyntheticCIFAR10
from ml_trainer_tpu_torch.utils import custom_pre_process_function

DATA_DIR = os.environ.get("DATA_DIR", "data")
MODEL_DIR = os.environ.get("MODEL_DIR", "model_output")
DEVICE = _bootstrap.device()


def build_datasets():
    transform = custom_pre_process_function()
    try:
        return (
            CIFAR10(DATA_DIR, train=True, transform=transform),
            CIFAR10(DATA_DIR, train=False, transform=transform),
        )
    except FileNotFoundError:
        print("CIFAR-10 not on disk; using synthetic data")
        n = int(os.environ.get("SYNTH_SIZE", "2048"))
        return (
            SyntheticCIFAR10(size=n, transform=transform),
            SyntheticCIFAR10(size=n // 4, transform=transform, seed=1),
        )


def main():
    import json
    import time

    datasets = build_datasets()
    # The reference notebook's config dict (01 nb cell-8).
    config = {
        "seed": 32,
        "scheduler": "CosineAnnealingWarmRestarts",
        "optimizer": "sgd",
        "momentum": 0.9,
        "weight_decay": 0.0,
        "lr": 0.001,
        "criterion": "cross_entropy",
        "metric": "accuracy",
        "pred_function": "softmax",
        "model_dir": MODEL_DIR,
    }
    trainer = Trainer(
        init_model("mlmodel", seed=config["seed"], device=DEVICE),
        datasets=datasets, epochs=int(os.environ.get("EPOCHS", "6")),
        batch_size=32, save_history=True, device=DEVICE, **config,
    )
    t0 = time.perf_counter()
    trainer.fit()
    fit_secs = time.perf_counter() - t0

    history = load_history(MODEL_DIR)
    print({k: v[-1] if isinstance(v, list) and v else v
           for k, v in history.items()})
    if os.environ.get("PLOT"):
        plot_history(history)

    loaded = load_model(MLModel(device=DEVICE), MODEL_DIR)
    test_loader = Loader(datasets[1], batch_size=32, shuffle=True)
    test_loss, test_acc = trainer.test(loaded, test_loader)
    print(f"test loss {test_loss:.4f}  accuracy {test_acc:.4f}")

    # The run's record, as the JAX example writes it (the reference's
    # committed notebook outputs, 01 nb cell-12/16).
    golden_out = os.environ.get("GOLDEN_OUT")
    if golden_out:
        n_train = len(datasets[0]) * trainer.epochs
        record = {
            "backend": str(trainer.device),
            "synthetic": type(datasets[0]).__name__ == "SyntheticCIFAR10",
            "train_size": len(datasets[0]),
            "epochs": trainer.epochs,
            "history": history,
            "test_loss": float(test_loss),
            "test_accuracy": float(test_acc),
            "fit_wall_secs": round(fit_secs, 2),
            "train_samples_per_sec_incl_compile": round(n_train / fit_secs, 1),
        }
        with open(golden_out, "w") as f:
            json.dump(record, f, indent=1, default=float)
        print(f"golden record -> {golden_out}")
    return trainer, loaded, test_loss, test_acc


if __name__ == "__main__":
    main()
