"""The committed JPEG shard set ``tests/fixtures/jpeg224`` (written by
its ``make_jpeg224.py`` with PIL; the card's smoke reads it): the bytes
decode through the port's native decoder to the pixels PIL decodes, the
digests the card's run checks its decode against are this decode's, and
the generator still describes the images and labels."""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from ml_trainer_tpu_torch.data import NativeLoader, ShardedJpegDataset
from ml_trainer_tpu_torch.data.native import jpeg_decode_np

Image = pytest.importorskip("PIL.Image")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "jpeg224")
# The native decoder's IDCT rounds otherwise than libjpeg's: each pixel
# within 3 of PIL's (data/sharded.py ``encode_jpeg_samples``).
IDCT_ATOL = 3


def _streams():
    ds = ShardedJpegDataset(ROOT)
    return ds, [blob[o[k]:o[k + 1]]
                for blob, o in zip(ds.byte_maps, ds.offset_tables)
                for k in range(len(o) - 1)]


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg224", os.path.join(ROOT, "make_jpeg224.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_size_and_layout():
    ds, streams = _streams()
    assert len(ds) == len(streams) == 64 and ds.shape == (224, 224, 3)
    total = sum(os.path.getsize(os.path.join(ROOT, f))
                for f in os.listdir(ROOT))
    assert total <= 4 * 2 ** 20
    assert len(ds.byte_maps) == 4


def test_native_decode_matches_pil():
    ds, streams = _streams()
    worst, diffs = 0, []
    for data in streams:
        mine = jpeg_decode_np(data, ds.shape)
        pil = np.asarray(Image.open(io.BytesIO(data.tobytes())).convert(
            "RGB"))
        d = np.abs(mine.astype(int) - pil.astype(int))
        worst = max(worst, int(d.max()))
        diffs.append(d.mean())
    assert worst <= IDCT_ATOL
    assert np.mean(diffs) < 0.5


def test_committed_digests_are_the_native_decode():
    ds, streams = _streams()
    with open(os.path.join(ROOT, "pixels.json")) as fp:
        want = json.load(fp)["sha256"]
    got = [hashlib.sha256(jpeg_decode_np(s, ds.shape).tobytes()).hexdigest()
           for s in streams]
    assert got == want


def test_generator_describes_the_committed_images():
    gen = _generator()
    x, y = gen.images()
    ds, streams = _streams()
    np.testing.assert_array_equal(ds.targets, y)
    decoded = np.stack([jpeg_decode_np(s, ds.shape) for s in streams])
    # JPEG at quality 90 keeps the images up to their noise.
    assert np.abs(decoded.astype(int) - x.astype(int)).mean() < 6


def test_native_loader_yields_the_decoded_pixels():
    ds, streams = _streams()
    pixels = np.stack([jpeg_decode_np(s, ds.shape) for s in streams])
    loader = NativeLoader(ds, 32, shuffle=False, pad=0, flip=False,
                          normalize=((0.0,) * 3, (1.0,) * 3))
    x = np.concatenate([b for b, _ in loader])
    loader.stop()
    np.testing.assert_array_equal(np.rint(x * 255.0).astype(np.uint8),
                                  pixels)
