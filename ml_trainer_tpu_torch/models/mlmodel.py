"""MLModel: the reference's LeNet-style CIFAR-10 CNN (the JAX package's
``models/mlmodel.py``).

Conv(3->6, 5x5, VALID) -> ReLU -> MaxPool(2, 2) -> Conv(6->16, 5x5,
VALID) -> ReLU -> MaxPool(2, 2) -> flatten(400) -> Dense(120) -> ReLU ->
Dense(84) -> ReLU -> Dense(num_classes).

Inputs are NHWC, as the ``Loader`` gives them; the convolutions see the
NCHW-shaped permutation (a channels-last view).  The flatten is in
H, W, C order, as in the JAX package, so ``fc1``'s weight is flax's
kernel transposed and nothing more.  As in the JAX package it has no
``dtype`` knob: under a bf16 policy the Trainer's cast of its
parameters and inputs makes it compute in bf16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import Conv
from ml_trainer_tpu_torch.models.registry import register_model


class MLModel(nn.Module):
    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device)
        self.conv1 = Conv(3, 6, 5, padding="VALID", **kw)
        self.conv2 = Conv(6, 16, 5, padding="VALID", **kw)
        self.fc1 = nn.Linear(16 * 5 * 5, 120, **kw)  # 32x32 inputs
        self.fc2 = nn.Linear(120, 84, **kw)
        self.fc3 = nn.Linear(84, num_classes, **kw)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # H, W, C order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


register_model("mlmodel")(MLModel)
