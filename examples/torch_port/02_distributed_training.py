"""Data-parallel training, the 02_ML_Training_SageMaker_distributed.ipynb
flow, on the port (``examples/02_distributed_training.py`` is the JAX
package's).

Where the reference launches main.py under SMDDP on several GPUs, the
port runs one process per card under ``torchrun`` (``PROCESSES``: NCCL
on the cards, each process's replica on ``cuda:<LOCAL_RANK>``; gloo on
the CPU under ``BACKEND=cpu``), or its replicas in one process that
share one device (``REPLICAS``, ``device=["cuda"] * REPLICAS``: the
counterpart of the JAX example's rehearsal on 8 host devices).

    python examples/torch_port/02_distributed_training.py       # card
    BACKEND=cpu SYNTH_SIZE=64 BATCH_SIZE=16 EPOCHS=1 \
        python examples/torch_port/02_distributed_training.py   # CPU
    RESUME=1 python examples/torch_port/02_distributed_training.py
    # one process per card; PROCESSES > 1 relaunches the script so:
    python -m torch.distributed.run --nproc_per_node 2 \
        examples/torch_port/02_distributed_training.py
    BACKEND=cpu PROCESSES=2 python examples/torch_port/02_distributed_training.py

Knobs (env vars): MODEL (resnet18), PROCESSES (1: the replicas share one
process; N: N processes of one replica each), REPLICAS (2, with one
process), EPOCHS (2), BATCH_SIZE (256), SYNTH_SIZE (4096), RESUME, TP (a
tensor axis: refused, ROADMAP.md Queue A 6).
"""

import _bootstrap  # noqa: F401  (repo root onto sys.path)
import os
import subprocess
import sys

from ml_trainer_tpu_torch import Trainer, init_model
from ml_trainer_tpu_torch.data import SyntheticCIFAR10
from ml_trainer_tpu_torch.utils import custom_pre_process_function

MODEL_DIR = os.environ.get("MODEL_DIR", "model_output_distributed")
TP = int(os.environ.get("TP", "1"))
MODEL = os.environ.get("MODEL", "resnet18")
REPLICAS = int(os.environ.get("REPLICAS", "2"))
PROCESSES = int(os.environ.get("PROCESSES", "1"))
DEVICE = _bootstrap.device()


def relaunch() -> int:
    """This script under ``torchrun``, one process per replica."""
    return subprocess.call([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        f"--nproc_per_node={PROCESSES}", os.path.abspath(__file__)])


def main():
    transform = custom_pre_process_function()
    n = int(os.environ.get("SYNTH_SIZE", "4096"))
    datasets = (
        SyntheticCIFAR10(size=n, transform=transform),
        SyntheticCIFAR10(size=max(n // 8, 64), transform=transform, seed=1),
    )
    # The reference's hyperparameters dict (02 nb cell-4), same keys;
    # 'smddp' maps to the card, 'gloo' (the reference's local rehearsal)
    # to the CPU.
    config = {
        "seed": 32,
        "optimizer": "sgd",
        "momentum": 0.9,
        "lr": 0.01,
        "criterion": "cross_entropy",
        "metric": "accuracy",
        "pred_function": "softmax",
        "model_dir": MODEL_DIR,
        "backend": "gloo" if DEVICE == "cpu" else "smddp",
    }
    mesh_shape = None
    if TP > 1:
        mesh_shape = {"data": REPLICAS // TP, "tensor": TP}
    # Under torchrun each process holds one replica: the CPU, or the
    # card cuda:<LOCAL_RANK> the Trainer picks.
    multi = "WORLD_SIZE" in os.environ
    device = ("cpu" if DEVICE == "cpu" else None) if multi else (
        [DEVICE] * REPLICAS)
    trainer = Trainer(
        init_model(MODEL, seed=config["seed"],
                   device="cpu" if DEVICE == "cpu" or multi else DEVICE),
        datasets=datasets,
        epochs=int(os.environ.get("EPOCHS", "2")),
        batch_size=int(os.environ.get("BATCH_SIZE", "256")),
        is_parallel=True,
        save_history=True,
        mesh_shape=mesh_shape,
        device=device,
        **config,
    )
    trainer.fit(resume=os.environ.get("RESUME") == "1")
    print({k: (v[-1] if isinstance(v, list) and v else v)
           for k, v in trainer.history.items()})
    return trainer


if __name__ == "__main__":
    if PROCESSES > 1 and "WORLD_SIZE" not in os.environ:
        sys.exit(relaunch())
    main()
