"""``python -m ml_trainer_tpu_torch``: the port's training CLI (``cli``)."""

from ml_trainer_tpu_torch.cli import cli

if __name__ == "__main__":
    cli()
