"""Write the committed JPEG shard set ``tests/fixtures/jpeg224/``: 64
seeded 224 x 224 RGB images (gradients, a sinusoidal texture and mild
noise, on which JPEG behaves as on photographs), baseline JPEG at
quality 90 with 4:4:4 chroma (``data.sharded.encode_jpeg_samples``), in
4 shards of 16 (``write_sharded_jpeg_dataset``), labels 0-9 from the
seed.  ``pixels.json`` holds the sha256 of each image's pixels as the
port's native decoder (``data.native.jpeg_decode_np``) gives them on the
CPU, which a run elsewhere checks its own decode against.

PIL encodes; the card's machine need not have it, which is why the
shards are committed rather than written at run time.

    python tests/fixtures/jpeg224/make_jpeg224.py
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from ml_trainer_tpu_torch.data.native import jpeg_decode_np  # noqa: E402
from ml_trainer_tpu_torch.data.sharded import (  # noqa: E402
    ShardedJpegDataset,
    encode_jpeg_samples,
    write_sharded_jpeg_dataset,
)

SEED, N, SIDE, QUALITY, PER_SHARD = 0, 64, 224, 90, 16


def images(n: int = N, side: int = SIDE, seed: int = SEED):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    out = np.empty((n, side, side, 3), np.uint8)
    for i in range(n):
        fx, fy = rng.uniform(4.0, 24.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([
            (xx + 7 * i) % side * 255.0 / side,
            yy * 255.0 / side,
            128 + 96 * np.sin(xx / fx + phase[0]) * np.cos(yy / fy + phase[1]),
        ], -1)
        out[i] = np.clip(base + rng.normal(0, 8, base.shape), 0, 255)
    return out, rng.integers(0, 10, size=n).astype(np.int32)


def pixel_digests(root: str) -> list:
    ds = ShardedJpegDataset(root)
    digests = []
    for s, (blob, offsets) in enumerate(zip(ds.byte_maps, ds.offset_tables)):
        for k in range(len(offsets) - 1):
            px = jpeg_decode_np(blob[offsets[k]:offsets[k + 1]], ds.shape)
            digests.append(hashlib.sha256(px.tobytes()).hexdigest())
    return digests


def main() -> None:
    x, y = images()
    write_sharded_jpeg_dataset(
        HERE, encode_jpeg_samples([(x, y)], quality=QUALITY, subsampling=0),
        shape=x.shape[1:], samples_per_shard=PER_SHARD)
    with open(os.path.join(HERE, "pixels.json"), "w") as fp:
        json.dump({"decoder": "ml_trainer_tpu_torch.data.native."
                   "jpeg_decode_np", "sha256": pixel_digests(HERE)}, fp,
                  indent=1)


if __name__ == "__main__":
    main()
