"""Batch transforms on NHWC numpy batches (the JAX package's
``data/transforms.py``, copied so that the port imports nothing of it).

Each transform takes a whole batch ``[B, H, W, C]`` and an explicit
``np.random.Generator``, and makes the same draws in the same order as
the JAX package's, so both packages produce the same batches bit for bit.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class Transform:
    def __call__(self, batch: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class Compose(Transform):
    """Sequential composition (torchvision ``Compose``'s counterpart)."""

    def __init__(self, transforms: Iterable[Transform]):
        self.transforms = list(transforms)

    def __call__(self, batch, rng):
        for t in self.transforms:
            batch = t(batch, rng)
        return batch

    def __repr__(self):
        return f"Compose({self.transforms})"


class RandomCrop(Transform):
    """Random crop after zero padding, one offset per sample (torchvision
    ``RandomCrop(size, padding)``)."""

    def __init__(self, size: int, padding: int = 0):
        self.size = size
        self.padding = padding

    def __call__(self, batch, rng):
        b = batch.shape[0]
        p, s = self.padding, self.size
        if p:
            batch = np.pad(batch, ((0, 0), (p, p), (p, p), (0, 0)),
                           mode="constant")
        max_off = batch.shape[1] - s, batch.shape[2] - s
        oy = rng.integers(0, max_off[0] + 1, size=b)
        ox = rng.integers(0, max_off[1] + 1, size=b)
        # A (B, offy, offx, C, s, s) view; one gather for the batch.
        windows = np.lib.stride_tricks.sliding_window_view(
            batch, (s, s), axis=(1, 2))
        out = windows[np.arange(b), oy, ox]  # (B, C, s, s)
        return np.ascontiguousarray(out.transpose(0, 2, 3, 1))


class RandomHorizontalFlip(Transform):
    """Flip each sample left-right with probability ``p``."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, batch, rng):
        mask = rng.random(batch.shape[0]) < self.p
        out = batch.copy()
        out[mask] = out[mask, :, ::-1]
        return out


class ToFloat(Transform):
    """uint8 [0, 255] -> float32 [0, 1], NHWC kept (torchvision
    ``ToTensor`` also transposes to CHW)."""

    def __call__(self, batch, rng):
        if batch.dtype == np.uint8:
            return batch.astype(np.float32) / 255.0
        return batch.astype(np.float32)


class Normalize(Transform):
    """Per-channel (x - mean) / std."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, batch, rng):
        return (batch - self.mean) / self.std


class ForeignTransform(Transform):
    """A per-sample transform with a foreign signature (a torchvision
    ``Compose`` carried by a reference-style dataset), applied sample by
    sample: a uint8 HWC sample goes in as a PIL image when PIL is
    installed, a CHW tensor that comes out is turned back to HWC numpy,
    and the samples are stacked again."""

    def __init__(self, fn):
        self.fn = fn

    @staticmethod
    def _to_pil(sample):
        try:
            from PIL import Image

            return Image.fromarray(sample)
        except ImportError:
            return sample

    def __call__(self, batch, rng):
        out = []
        for sample in batch:
            if sample.dtype == np.uint8 and sample.ndim == 3:
                sample = self._to_pil(sample)  # torchvision expects PIL
            x = self.fn(sample)
            if hasattr(x, "numpy"):  # a torch tensor, CHW float
                x = x.numpy()
                if x.ndim == 3 and x.shape[0] in (1, 3):
                    x = x.transpose(1, 2, 0)
            out.append(np.asarray(x))
        return np.stack(out)
