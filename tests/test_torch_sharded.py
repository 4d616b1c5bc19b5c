"""Port parity: the memory-mapped shard datasets of
``ml_trainer_tpu_torch.data.sharded`` and the JPEG path of its
``NativeLoader``, against the JAX package on the CPU (PIL encodes the
JPEGs here; the card's machine has no PIL).

* Raw uint8 shards written by either package are read by the other bit
  for bit (``__getitem__``, ``batch``, labels, shard layout).
* JPEG shards: the port's ``ShardedJpegDataset`` decodes (through the
  native decoder, ``csrc/jpeg_decoder.cpp``) to the JAX package's pixels
  bit for bit, and the port's JPEG ``NativeLoader`` gives the JAX one's
  batches bit for bit.
* ``ingest_image_folder`` writes the same shards in both packages.
* A corrupt stream, and the ``decode_error`` fault, raise at the epoch's
  end, with the JAX package's message.
"""

import json
import os

import numpy as np
import pytest

from ml_trainer_tpu.data import native as jnative
from ml_trainer_tpu.data import sharded as jsh
from ml_trainer_tpu.resilience import faults as jfaults
from ml_trainer_tpu_torch.data import native as tnative
from ml_trainer_tpu_torch.data import sharded as tsh
from ml_trainer_tpu_torch.data.loader import Loader
from ml_trainer_tpu_torch.data.transforms import Compose, Normalize, ToFloat
from ml_trainer_tpu_torch.resilience import faults as tfaults

Image = pytest.importorskip("PIL.Image")


def _images(n, h=24, w=24, seed=0):
    """Structured uint8 RGB images (gradients, texture and noise), on
    which JPEG behaves as on photographs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                     128 + 96 * np.sin(xx / 5.0) * np.cos(yy / 7.0)], -1)
    return np.stack([np.clip(np.roll(base, 3 * i, axis=1)
                             + rng.normal(0, 10, base.shape), 0, 255)
                     for i in range(n)]).astype(np.uint8)


def _chunks(x, y, size):
    return [(x[i:i + size], y[i:i + size]) for i in range(0, len(x), size)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_raw_shards_cross_read_bitwise(tmp_path, writer):
    x = np.random.default_rng(1).integers(0, 256, (50, 8, 8, 3),
                                          dtype=np.uint8)
    y = np.arange(50, dtype=np.int32) % 7
    write = (tsh if writer == "port" else jsh).write_sharded_dataset
    root = write(str(tmp_path / "ds"), _chunks(x, y, 9), samples_per_shard=16)
    t, j = tsh.ShardedImageDataset(root), jsh.ShardedImageDataset(root)
    assert len(t) == len(j) == 50 and t.shape == j.shape == (8, 8, 3)
    np.testing.assert_array_equal(t.shard_starts, j.shard_starts)
    np.testing.assert_array_equal(t.targets, j.targets)
    idx = np.random.default_rng(2).permutation(50)[:23]
    for a, b in zip(t.batch(idx), j.batch(idx)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.batch(idx)[0], x[idx])
    for i in (0, 17, 49, -1):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]
    with pytest.raises(IndexError):
        t[50]


def test_raw_shards_through_both_loaders_equal_the_arrays(tmp_path):
    x = np.random.default_rng(3).integers(0, 256, (40, 8, 8, 3),
                                          dtype=np.uint8)
    y = np.arange(40, dtype=np.int32)
    root = tsh.write_sharded_dataset(str(tmp_path / "ds"), [(x, y)],
                                     samples_per_shard=12)
    norm = Compose([ToFloat(), Normalize((0.5,) * 3, (0.25,) * 3)])
    ds = tsh.ShardedImageDataset(root, transform=norm)
    plan = tnative.native_plan(ds)
    assert plan == dict(pad=0, flip=False,
                        normalize=((0.5,) * 3, (0.25,) * 3))
    port = tnative.NativeLoader(ds, 8, shuffle=True, seed=4, **plan)
    jax_ = jnative.NativeLoader(jsh.ShardedImageDataset(root), 8,
                                shuffle=True, seed=4, **plan)
    for (a, ay), (b, by) in zip(port, jax_):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ay, by)
    python = Loader(ds, 8, shuffle=False)
    native = tnative.NativeLoader(ds, 8, shuffle=False, **plan)
    for (a, ay), (b, by) in zip(python, native):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ay, by)


def test_codec_mismatch_errors_match(tmp_path):
    raw = tsh.write_sharded_dataset(str(tmp_path / "raw"),
                                    [(_images(4), np.zeros(4))])
    jpg = tsh.write_sharded_jpeg_dataset(
        str(tmp_path / "jpg"), tsh.encode_jpeg_samples(
            [(_images(4), np.zeros(4))]), shape=(24, 24, 3))
    for mod in (tsh, jsh):
        with pytest.raises(ValueError, match="ShardedJpegDataset"):
            mod.ShardedImageDataset(jpg)
        with pytest.raises(ValueError, match="use ShardedImageDataset"):
            mod.ShardedJpegDataset(raw)
        with pytest.raises(ValueError, match="must be uint8"):
            mod.write_sharded_dataset(str(tmp_path / "f"),
                                      [(np.zeros((2, 4, 4, 3)), [0, 1])])


@pytest.mark.parametrize("subsampling", [0, 2])
def test_jpeg_shards_decode_and_load_bitwise_the_jax_package(tmp_path,
                                                             subsampling):
    x, y = _images(30, seed=subsampling), np.arange(30, dtype=np.int32)
    samples = list(tsh.encode_jpeg_samples([(x, y)], subsampling=subsampling))
    assert samples == list(jsh.encode_jpeg_samples([(x, y)],
                                                   subsampling=subsampling))
    root = tsh.write_sharded_jpeg_dataset(str(tmp_path / "jds"), samples,
                                          shape=x.shape[1:],
                                          samples_per_shard=8)
    t, j = tsh.ShardedJpegDataset(root), jsh.ShardedJpegDataset(root)
    idx = np.arange(30)[::-1]
    for a, b in zip(t.batch(idx), j.batch(idx)):
        np.testing.assert_array_equal(a, b)
    # The source images, up to JPEG's loss of their noise (a stream read
    # wrong would be off by ~85 on average).
    assert np.abs(t.batch(idx)[0].astype(int) - x[idx]).mean() < 20
    kw = dict(batch_size=8, pad=2, flip=True, seed=3, drop_last=False)
    port, jax_ = tnative.NativeLoader(t, **kw), jnative.NativeLoader(j, **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        for (a, ay), (b, by) in zip(port, jax_):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ay, by)
    port.stop()


def _corrupt_first(root):
    with open(os.path.join(root, "index.json")) as fp:
        shard = json.load(fp)["shards"][0]
    offsets = np.load(os.path.join(root, shard["o"]))
    with open(os.path.join(root, shard["j"]), "r+b") as fp:
        fp.seek(int(offsets[0]))
        fp.write(b"\x00" * 64)


def test_corrupt_stream_raises_at_epoch_end_and_on_stop(tmp_path):
    root = tsh.write_sharded_jpeg_dataset(
        str(tmp_path / "jds"), tsh.encode_jpeg_samples(
            [(_images(16), np.zeros(16))]), shape=(24, 24, 3))
    _corrupt_first(root)
    loader = tnative.NativeLoader(tsh.ShardedJpegDataset(root), 8,
                                  shuffle=False, pad=0, flip=False)
    with pytest.raises(RuntimeError, match="1 sample\\(s\\) failed JPEG "
                                           "decode this epoch"):
        for _ in loader:
            pass
    loader = tnative.NativeLoader(tsh.ShardedJpegDataset(root), 4,
                                  shuffle=False, pad=0, flip=False,
                                  queue_cap=1, num_threads=1)
    it = iter(loader)
    next(it)  # the corrupt sample's batch; then an early break
    it.close()
    with pytest.raises(RuntimeError, match="since the last check"):
        loader.stop()
    loader.stop()
    with pytest.raises(ValueError, match="jpeg_decode failed"):
        tsh.ShardedJpegDataset(root)[0]


@pytest.mark.parametrize("spec,raises", [("decode_error@epoch=1", True),
                                         ("decode_error@epoch=0", False)])
def test_decode_error_fault_raises_at_the_epoch_end_as_in_jax(tmp_path, spec,
                                                              raises):
    root = tsh.write_sharded_jpeg_dataset(
        str(tmp_path / "jds"), tsh.encode_jpeg_samples(
            [(_images(8), np.zeros(8))]), shape=(24, 24, 3))
    assert "decode_error" in tfaults.KINDS
    assert "decode_error" not in tfaults.UNPORTED_KINDS
    msgs = []
    for sh, nat, fl in ((tsh, tnative, tfaults), (jsh, jnative, jfaults)):
        loader = nat.NativeLoader(sh.ShardedJpegDataset(root), 4, pad=0,
                                  flip=False)
        loader.set_epoch(1)
        with fl.injected(spec):
            try:
                seen = sum(1 for _ in loader)
                msgs.append(None)
            except RuntimeError as err:
                msgs.append(str(err))
                seen = 2
        assert seen == 2
    assert msgs[0] == msgs[1]
    assert (msgs[0] is not None) == raises


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_ingest_image_folder_writes_the_jax_packages_shards(tmp_path, codec):
    src = tmp_path / "folder"
    imgs = _images(7, h=20, w=30)
    for i, img in enumerate(imgs):
        d = src / ("cat" if i % 2 else "dog")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(d / f"{i}.png")
    (src / "cat" / "notes.txt").write_text("not an image")
    roots = [mod.ingest_image_folder(str(src), str(tmp_path / name),
                                     size=(16, 16), samples_per_shard=3,
                                     codec=codec)
             for name, mod in (("t", tsh), ("j", jsh))]
    indexes = []
    for root in roots:
        with open(os.path.join(root, "index.json")) as fp:
            indexes.append(json.load(fp))
    assert indexes[0] == indexes[1]
    assert indexes[0]["classes"] == ["cat", "dog"]
    cls = tsh.ShardedImageDataset if codec == "raw" else tsh.ShardedJpegDataset
    a, b = cls(roots[0]), cls(roots[1])
    for u, v in zip(a.batch(np.arange(7)), b.batch(np.arange(7))):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="codec must be"):
        tsh.ingest_image_folder(str(src), str(tmp_path / "x"), codec="png")
