"""Beyond-RAM datasets (the JAX package's ``data/sharded.py``, copied so
that the port imports nothing of it): sharded on-disk images,
memory-mapped.

Images live in per-shard ``.npy`` files and are memory-mapped, so batch
gathers fault in only the pages they touch and the OS page cache, not
the Python process, decides residency.  Labels (4 bytes a sample) stay
in RAM.  The on-disk format is the JAX package's, so each package reads
the shards the other wrote.

Layout of a dataset directory::

    index.json                {"shards": [{"x": ..., "y": ..., "n": ...}],
                               "shape": [H, W, C], "total": N}
    shard_00000_x.npy         [n, H, W, C] uint8 images
    shard_00000_y.npy         [n] int32 labels
    ...

Both loaders consume it: the Python ``Loader`` through ``batch()``
(per-shard fancy-indexing into the maps), and the C++ ``NativeLoader``
through a shard pointer table (``csrc/batch_worker.cpp`` gathers
straight from the mapped pages on its worker threads).  The compressed
variant (``write_sharded_jpeg_dataset``, ``ShardedJpegDataset``) keeps
baseline-JPEG streams; PIL, which encodes them, is imported only where
it is used.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.data.datasets import Dataset
from ml_trainer_tpu_torch.data.transforms import Transform

INDEX_FILE = "index.json"


def write_sharded_dataset(
    root: str,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    samples_per_shard: int = 8192,
) -> str:
    """Write an iterable of (images [n,H,W,C] uint8, labels [n]) chunks as
    a sharded dataset under ``root``.  Chunks are re-chunked to exactly
    ``samples_per_shard`` per shard (last shard ragged), so the writer
    itself is streaming: peak RAM is one shard, regardless of dataset
    size."""
    os.makedirs(root, exist_ok=True)
    shards, shape = [], None
    buf_x: list = []
    buf_y: list = []
    buffered = 0

    def flush(n):
        nonlocal buffered
        cat_x, cat_y = np.concatenate(buf_x), np.concatenate(buf_y)
        x, rest_x = cat_x[:n], cat_x[n:]
        y, rest_y = cat_y[:n].astype(np.int32), cat_y[n:]
        i = len(shards)
        fx, fy = f"shard_{i:05d}_x.npy", f"shard_{i:05d}_y.npy"
        np.save(os.path.join(root, fx), np.ascontiguousarray(x),
                allow_pickle=False)
        np.save(os.path.join(root, fy), y, allow_pickle=False)
        shards.append({"x": fx, "y": fy, "n": int(n)})
        buf_x[:] = [rest_x] if len(rest_x) else []
        buf_y[:] = [rest_y] if len(rest_y) else []
        buffered = len(rest_x)

    for x, y in batches:
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != np.uint8:
            raise ValueError(f"images must be uint8, got {x.dtype}")
        if shape is None:
            shape = x.shape[1:]
        elif tuple(x.shape[1:]) != tuple(shape):
            raise ValueError(f"chunk shape {x.shape[1:]} != first {shape}")
        buf_x.append(x)
        buf_y.append(y)
        buffered += len(x)
        while buffered >= samples_per_shard:
            flush(samples_per_shard)
    if buffered:
        flush(buffered)
    index = {
        "shards": shards,
        "shape": list(shape) if shape is not None else [],
        "total": int(sum(s["n"] for s in shards)),
    }
    with open(os.path.join(root, INDEX_FILE), "w") as fp:
        json.dump(index, fp)
    return root


class ShardedImageDataset(Dataset):
    """Memory-mapped sharded image dataset (see module docstring).

    Satisfies the ``Dataset`` protocol plus the Loader's fast
    ``batch(indices)`` path; ``shard_maps``/``shard_starts`` expose the
    mapped segments for the native worker's pointer table."""

    def __init__(self, root: str, transform: Optional[Transform] = None):
        with open(os.path.join(root, INDEX_FILE)) as fp:
            index = json.load(fp)
        codec = index.get("codec", "raw")
        if codec != "raw":
            raise ValueError(
                f"{root!r} holds {codec!r}-codec shards, not raw uint8 "
                "pixel shards; open it with ShardedJpegDataset"
            )
        self.root = root
        self.transform = transform
        self.shape = tuple(index["shape"])
        self.total = int(index["total"])
        # mmap_mode='r': mapping is O(1) — no bytes are read until touched.
        self.shard_maps = [
            np.load(os.path.join(root, s["x"]), mmap_mode="r",
                    allow_pickle=False)
            for s in index["shards"]
        ]
        for m, s in zip(self.shard_maps, index["shards"]):
            if m.dtype != np.uint8 or tuple(m.shape[1:]) != self.shape:
                raise ValueError(
                    f"shard {s['x']}: {m.dtype} {m.shape} does not match "
                    f"index uint8 {self.shape}"
                )
        counts = np.asarray([s["n"] for s in index["shards"]], np.int64)
        # shard_starts[i] = first global index of shard i (+ total sentinel).
        self.shard_starts = np.concatenate([[0], np.cumsum(counts)])
        # Labels are tiny — hold them in RAM as one array.
        self.targets = np.concatenate([
            np.load(os.path.join(root, s["y"]), allow_pickle=False)
            for s in index["shards"]
        ]).astype(np.int32)
        assert len(self.targets) == self.total, (len(self.targets), self.total)

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, idx: int):
        # Python indexing semantics match ArrayDataset — streaming is a
        # residency decision, not a semantics change.
        if idx < 0:
            idx += self.total
        if not 0 <= idx < self.total:
            raise IndexError(
                f"index {idx} out of range for dataset of {self.total}"
            )
        s = int(np.searchsorted(self.shard_starts, idx, "right") - 1)
        return (
            np.asarray(self.shard_maps[s][idx - self.shard_starts[s]]),
            self.targets[idx],
        )

    def batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched gather across the maps — the Loader's hot path.  One
        fancy-index per touched shard; only the touched pages fault in."""
        indices = np.asarray(indices)
        out = np.empty((len(indices),) + self.shape, np.uint8)
        shard_of = np.searchsorted(self.shard_starts, indices, "right") - 1
        for s in np.unique(shard_of):
            rows = shard_of == s
            out[rows] = self.shard_maps[s][indices[rows] - self.shard_starts[s]]
        return out, self.targets[indices]


def write_sharded_jpeg_dataset(
    root: str,
    samples: "Iterable[Tuple[bytes, int]]",
    shape: Tuple[int, int, int],
    samples_per_shard: int = 8192,
) -> str:
    """Write (jpeg_bytes, label) samples as COMPRESSED shards: each shard
    is one ``.bin`` of concatenated baseline-JPEG streams plus an
    ``[n+1]`` int64 offset table — the dataset stays at ~source size on
    disk (raw uint8 shards cost ~13x for ImageNet-class inputs), and the
    C++ worker decodes per sample on its threads
    (csrc/jpeg_decoder.cpp).  ``shape`` is the (H, W, C) every stream
    must decode to (the worker validates per image)."""
    os.makedirs(root, exist_ok=True)
    shards = []
    buf: list = []
    labels: list = []

    def flush():
        i = len(shards)
        fj, fo = f"shard_{i:05d}_j.bin", f"shard_{i:05d}_o.npy"
        fy = f"shard_{i:05d}_y.npy"
        offsets = np.zeros(len(buf) + 1, np.int64)
        np.cumsum([len(b) for b in buf], out=offsets[1:])
        with open(os.path.join(root, fj), "wb") as fp:
            for b in buf:
                fp.write(b)
        np.save(os.path.join(root, fo), offsets, allow_pickle=False)
        np.save(os.path.join(root, fy), np.asarray(labels, np.int32),
                allow_pickle=False)
        shards.append({"j": fj, "o": fo, "y": fy, "n": len(buf)})
        buf.clear()
        labels.clear()

    for data, label in samples:
        buf.append(bytes(data))
        labels.append(int(label))
        if len(buf) >= samples_per_shard:
            flush()
    if buf:
        flush()
    index = {
        "codec": "jpeg",
        "shards": shards,
        "shape": list(shape),
        "total": int(sum(s["n"] for s in shards)),
    }
    with open(os.path.join(root, INDEX_FILE), "w") as fp:
        json.dump(index, fp)
    return root


def encode_jpeg_samples(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    quality: int = 88,
    subsampling: int = 0,
):
    """(images [n,H,W,C] uint8, labels) chunks -> (jpeg_bytes, label)
    samples for ``write_sharded_jpeg_dataset``.  ``subsampling=0``
    (4:4:4) is the default: no chroma upsampling at decode, so the
    native decoder matches libjpeg to IDCT rounding (±3); 2 (4:2:0)
    halves the size again and decodes through the triangular upsampler."""
    import io

    from PIL import Image

    for x, y in batches:
        x = np.asarray(x)
        if x.dtype != np.uint8:
            raise ValueError(f"images must be uint8, got {x.dtype}")
        for img, label in zip(x, y):
            buf = io.BytesIO()
            Image.fromarray(img).save(
                buf, "JPEG", quality=quality, subsampling=subsampling
            )
            yield buf.getvalue(), int(label)


class ShardedJpegDataset(Dataset):
    """Compressed sharded dataset (``write_sharded_jpeg_dataset``
    layout): JPEG byte streams memory-mapped per shard, offset tables
    and labels in RAM.

    ``__getitem__``/``batch`` decode through the native decoder
    (csrc/jpeg_decoder.cpp) so the Python path and the C++ worker
    produce BIT-EQUAL pixels; PIL is the fallback when the native
    library is unavailable (same images to ±3 — IDCT rounding)."""

    def __init__(self, root: str, transform: Optional[Transform] = None):
        with open(os.path.join(root, INDEX_FILE)) as fp:
            index = json.load(fp)
        if index.get("codec") != "jpeg":
            raise ValueError(
                f"{root!r} is not a jpeg-sharded dataset "
                f"(codec={index.get('codec')!r}); use ShardedImageDataset"
            )
        self.root = root
        self.transform = transform
        self.shape = tuple(index["shape"])
        self.total = int(index["total"])
        self.byte_maps = [
            np.memmap(os.path.join(root, s["j"]), np.uint8, "r")
            for s in index["shards"]
        ]
        self.offset_tables = [
            np.load(os.path.join(root, s["o"]), allow_pickle=False)
            for s in index["shards"]
        ]
        for m, o, s in zip(self.byte_maps, self.offset_tables,
                           index["shards"]):
            if len(o) != s["n"] + 1 or o[-1] != len(m):
                raise ValueError(f"shard {s['j']}: offset table mismatch")
        counts = np.asarray([s["n"] for s in index["shards"]], np.int64)
        self.shard_starts = np.concatenate([[0], np.cumsum(counts)])
        self.targets = np.concatenate([
            np.load(os.path.join(root, s["y"]), allow_pickle=False)
            for s in index["shards"]
        ]).astype(np.int32)
        assert len(self.targets) == self.total

    def __len__(self) -> int:
        return self.total

    def _decode(self, data: np.ndarray) -> np.ndarray:
        from ml_trainer_tpu_torch.data.native import jpeg_decode_np

        out = jpeg_decode_np(data, self.shape)
        if out is not None:
            return out
        import io

        from PIL import Image

        return np.asarray(
            Image.open(io.BytesIO(data.tobytes())).convert("RGB")
        )

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += self.total
        if not 0 <= idx < self.total:
            raise IndexError(
                f"index {idx} out of range for dataset of {self.total}"
            )
        s = int(np.searchsorted(self.shard_starts, idx, "right") - 1)
        local = idx - self.shard_starts[s]
        o = self.offset_tables[s]
        return (
            self._decode(self.byte_maps[s][o[local]:o[local + 1]]),
            self.targets[idx],
        )

    def batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        indices = np.asarray(indices)
        out = np.empty((len(indices),) + self.shape, np.uint8)
        for i, idx in enumerate(indices):
            out[i] = self[int(idx)][0]
        return out, self.targets[indices]


def ingest_image_folder(
    src: str,
    dst: str,
    size: Tuple[int, int] = (224, 224),
    samples_per_shard: int = 4096,
    extensions: Tuple[str, ...] = (".jpg", ".jpeg", ".png", ".bmp"),
    decode_batch: int = 256,
    codec: str = "raw",
    quality: int = 88,
    subsampling: int = 0,
) -> str:
    """Decode a torchvision-``ImageFolder``-layout directory
    (``src/<class_name>/*.jpg``, classes labeled by sorted name) into the
    sharded on-disk format — the ImageNet ingestion path.

    ``codec='raw'`` (default — the original on-disk format; existing
    callers keep opening results with ``ShardedImageDataset``) writes
    uint8 pixel shards (~13x larger than source for ImageNet-class
    inputs).  ``codec='jpeg'`` opts into compressed shards: the resized
    images re-encode as baseline JPEG (~source size on disk; the C++
    worker decodes per sample — open with ``ShardedJpegDataset``).

    Decoding streams: ``decode_batch`` images are decoded (PIL), resized
    to ``size`` and handed to the sharded writer at a time, so peak RAM
    is one shard regardless of dataset size.  Returns ``dst``."""
    if codec not in ("raw", "jpeg"):
        raise ValueError(f"codec must be 'raw' or 'jpeg', got {codec!r}")
    from PIL import Image

    classes = sorted(
        d for d in os.listdir(src)
        if os.path.isdir(os.path.join(src, d))
    )
    if not classes:
        raise ValueError(f"no class directories under {src!r}")
    files = [
        (os.path.join(src, c, f), label)
        for label, c in enumerate(classes)
        for f in sorted(os.listdir(os.path.join(src, c)))
        if f.lower().endswith(extensions)
    ]
    if not files:
        raise ValueError(f"no image files under {src!r}")

    def chunks():
        for lo in range(0, len(files), decode_batch):
            part = files[lo : lo + decode_batch]
            xs = np.empty((len(part),) + size + (3,), np.uint8)
            ys = np.empty((len(part),), np.int32)
            for i, (path, label) in enumerate(part):
                with Image.open(path) as im:
                    xs[i] = np.asarray(
                        im.convert("RGB").resize(
                            (size[1], size[0]), Image.BILINEAR
                        )
                    )
                ys[i] = label
            yield xs, ys

    if codec == "jpeg":
        write_sharded_jpeg_dataset(
            dst,
            encode_jpeg_samples(chunks(), quality, subsampling),
            shape=size + (3,),
            samples_per_shard=samples_per_shard,
        )
    else:
        write_sharded_dataset(
            dst, chunks(), samples_per_shard=samples_per_shard
        )
    with open(os.path.join(dst, INDEX_FILE)) as fp:
        index = json.load(fp)
    index["classes"] = classes
    with open(os.path.join(dst, INDEX_FILE), "w") as fp:
        json.dump(index, fp)
    return dst
