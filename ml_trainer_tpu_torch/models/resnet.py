"""ResNet-18/50/101/152 (the JAX package's ``models/resnet.py``).

Inputs are NHWC, as the ``Loader`` gives them; every layer sees the
NCHW-shaped permutation, a channels-last view, which cuDNN takes as it
is.  Each "SAME" convolution pads as flax does (``layers.Conv``): at
stride 2 on an even input the odd pixel goes to the high side.
BatchNorm follows flax (``layers.BatchNorm``: biased variance in the
running update, momentum 0.9 on the old value).  Under data parallelism
the JAX package computes the statistics over the global batch (SyncBN);
the port's ``Trainer`` does the same by running a BatchNorm model over
each global microbatch at once.

``cifar_stem`` swaps the 7x7 stride-2 stem and its max pool for one 3x3
stride-1 conv, so ResNet-18 trains on 32x32 inputs.  A block's
``downsample`` (1x1 conv, no padding, and ``bn_down``) exists when its
stride is not 1 or its input width differs from its output width: flax's
``residual.shape != y.shape``, decided at construction.

``dtype`` is the compute dtype (``models/layers.py``): convolutions in
it, BatchNorm in float32 returning it, the ``head`` in float32, as in the
JAX package.  Parameters and running statistics stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
from torch import nn
from torch.nn import functional as F

from ml_trainer_tpu_torch.device import resolve_device
from ml_trainer_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    compute_dtype,
)
from ml_trainer_tpu_torch.models.registry import register_model


class _Block(nn.Module):
    expansion = 1

    def _shortcut(self, in_ch: int, out_ch: int, strides: int, kw) -> None:
        if strides != 1 or in_ch != out_ch:
            self.downsample = Conv(in_ch, out_ch, 1, strides,
                                   padding="VALID", bias=False, **kw)
            self.bn_down = BatchNorm(out_ch, **kw)
        else:
            self.downsample = None

    def _residual(self, x):
        if self.downsample is None:
            return x
        return self.bn_down(self.downsample(x))


class BasicBlock(_Block):
    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv(in_channels, filters, 3, strides, bias=False, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, bias=False, **kw)
        self.bn2 = BatchNorm(filters, **kw)
        self._shortcut(in_channels, filters, strides, kw)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self._residual(x))


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out = filters * self.expansion
        self.conv1 = Conv(in_channels, filters, 1, bias=False, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, strides, bias=False, **kw)
        self.bn2 = BatchNorm(filters, **kw)
        self.conv3 = Conv(filters, out, 1, bias=False, **kw)
        self.bn3 = BatchNorm(out, **kw)
        self._shortcut(in_channels, out, strides, kw)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + self._residual(x))


class ResNet(nn.Module):
    """Blocks are attributes ``stage{s}_block{b}`` (flax's names)."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[_Block],
                 num_classes: int = 1000, cifar_stem: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        cdt = compute_dtype(dtype)
        kw = dict(device=device, dtype=cdt)
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.stem_conv = Conv(3, 64, 3, bias=False, **kw)
        else:
            self.stem_conv = Conv(3, 64, 7, 2,
                                  padding=((3, 3), (3, 3)), bias=False, **kw)
        self.stem_bn = BatchNorm(64, **kw)
        width = 64
        self.block_names = []
        for stage, num_blocks in enumerate(stage_sizes):
            for b in range(num_blocks):
                strides = 2 if (stage > 0 and b == 0) else 1
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, block(width, 64 * 2 ** stage, strides,
                                            **kw))
                self.block_names.append(name)
                width = 64 * 2 ** stage * block.expansion
        # flax's Dense(dtype=float32); with no policy it casts nothing.
        self.head = Dense(width, num_classes, device=device,
                          dtype=None if cdt is None else torch.float32)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.stem_conv.weight.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as flax
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))  # global average pool


@register_model("resnet18")
def resnet18(num_classes: int = 10, cifar_stem: bool = True, **kw) -> ResNet:
    """ResNet-18 (the CIFAR-10 config, ``BASELINE.json`` configs[0])."""
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, **kw)


@register_model("resnet50")
def resnet50(num_classes: int = 1000, cifar_stem: bool = False,
             **kw) -> ResNet:
    """ResNet-50 (the ImageNet config, ``BASELINE.json`` configs[1])."""
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, **kw)


@register_model("resnet101")
def resnet101(num_classes: int = 1000, cifar_stem: bool = False,
              **kw) -> ResNet:
    """ResNet-101: the [3, 4, 23, 3] bottleneck stack."""
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, **kw)


@register_model("resnet152")
def resnet152(num_classes: int = 1000, cifar_stem: bool = False,
              **kw) -> ResNet:
    """ResNet-152: the [3, 8, 36, 3] bottleneck stack."""
    return ResNet([3, 8, 36, 3], BottleneckBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, **kw)
