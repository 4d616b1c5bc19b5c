"""ctypes bindings for the native batch worker (the JAX package's
``data/native.py``, with the port's own build of the same sources).

``NativeLoader`` is a drop-in alternative to the Python ``Loader`` for
uint8-image datasets: batch assembly (gather + crop + flip + normalize,
and for JPEG shards the decode) runs in C++ threads that stay
``queue_cap`` batches ahead of the training loop.  It yields numpy
batches, which ``prefetch_to_device`` takes as it takes the Python
``Loader``'s.

The library is built with ``g++`` on first use from the repository's
``csrc/batch_worker.cpp`` and ``csrc/jpeg_decoder.cpp`` into
``build/native/`` at the root of the checkout.  Its file name carries a
hash of both sources and the flags, so an edited source is rebuilt and a
stale library is never loaded; it is compiled to a private temporary
name and published by an atomic rename, so that processes building at
once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ml_trainer_tpu_torch.data.datasets import ArrayDataset
from ml_trainer_tpu_torch.data.sampler import ShardedSampler

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "csrc"
BUILD_DIR = _ROOT / "build" / "native"
SOURCES = ("batch_worker.cpp", "jpeg_decoder.cpp")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]
# The last build of this process: its seconds, and whether the library
# was already on disk.
BUILD_LOG: dict = {}
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """The library's path, named by a hash of the sources and flags."""
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libbatch_worker-{h.hexdigest()[:12]}.so"


def _build_library(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(
        ["g++", *FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)],
        capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/{SOURCES}:\n{out.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """The batch worker library, built first when it is not on disk."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        t0 = time.perf_counter()
        cached = path.exists()
        if not cached:
            _build_library(path)
        BUILD_LOG.update(seconds=time.perf_counter() - t0, cached=cached,
                         path=str(path))
        lib = ctypes.CDLL(str(path))
        lib.batch_worker_create_sharded.restype = ctypes.c_void_p
        lib.batch_worker_create_sharded.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.batch_worker_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_uint64,
        ]
        lib.batch_worker_next.restype = ctypes.c_int64
        lib.batch_worker_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.batch_worker_destroy.argtypes = [ctypes.c_void_p]
        lib.batch_worker_create_jpeg.restype = ctypes.c_void_p
        lib.batch_worker_create_jpeg.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.batch_worker_decode_errors.restype = ctypes.c_int64
        lib.batch_worker_decode_errors.argtypes = [ctypes.c_void_p]
        lib.jpeg_decode_expect.restype = ctypes.c_int
        lib.jpeg_decode_expect.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def jpeg_decode_np(data, shape) -> Optional[np.ndarray]:
    """Decode one baseline-JPEG byte buffer to uint8 [H, W, 3] through
    the native decoder, the code the C++ worker threads run, so that
    Python-side decodes are bit-equal to worker batches.  Returns None
    when the native library is unavailable (callers fall back to PIL)
    and raises on a corrupt stream."""
    try:
        lib = load_library()
    except Exception:
        return None
    data = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    out = np.empty(shape, np.uint8)
    rc = lib.jpeg_decode_expect(
        data.ctypes.data_as(ctypes.c_void_p), len(data),
        out.ctypes.data_as(ctypes.c_void_p), out.size,
        int(shape[1]), int(shape[0]),
    )
    if rc != 0:
        raise ValueError(f"jpeg_decode failed (rc={rc})")
    return out


def native_plan(dataset) -> Optional[dict]:
    """NativeLoader kwargs if this dataset can run through the fused C++
    pipeline with the same semantics as the Python Loader and its
    transform: uint8 NHWC data (an array dataset or the port's shard
    datasets) whose transform is the reference augmentation
    (RandomCrop(p)? + RandomHorizontalFlip? + ToFloat + Normalize).
    None when the Python path must be used (a foreign or no transform,
    float data, a flip probability other than 0.5, a crop size other
    than the image size)."""
    from ml_trainer_tpu_torch.data.sharded import (
        ShardedImageDataset,
        ShardedJpegDataset,
    )
    from ml_trainer_tpu_torch.data.transforms import (
        Compose,
        Normalize,
        RandomCrop,
        RandomHorizontalFlip,
        ToFloat,
    )

    data = getattr(dataset, "data", None)
    if isinstance(dataset, (ShardedImageDataset, ShardedJpegDataset)):
        # Memory-mapped shards: the worker gathers from the mapped
        # segments directly; JPEG shards decode on the worker threads.
        if len(dataset.shape) != 3:
            return None
        h, w = dataset.shape[0], dataset.shape[1]
    elif (isinstance(data, np.ndarray) and data.dtype == np.uint8
          and data.ndim == 4):
        h, w = data.shape[1], data.shape[2]
    else:
        return None
    t = getattr(dataset, "transform", None)
    if t is None:
        return None
    ts = list(t.transforms) if isinstance(t, Compose) else [t]
    i, pad, flip = 0, 0, False
    if i < len(ts) and isinstance(ts[i], RandomCrop):
        if ts[i].size != h or h != w:
            return None
        pad, i = ts[i].padding, i + 1
    if i < len(ts) and isinstance(ts[i], RandomHorizontalFlip):
        if ts[i].p != 0.5:
            return None
        flip, i = True, i + 1
    if not (i < len(ts) and isinstance(ts[i], ToFloat)):
        return None
    i += 1
    if not (i < len(ts) and isinstance(ts[i], Normalize)):
        return None
    normalize = (tuple(ts[i].mean.tolist()), tuple(ts[i].std.tolist()))
    i += 1
    if i != len(ts):
        return None
    return dict(pad=pad, flip=flip, normalize=normalize)


class NativeLoader:
    """C++-threaded Loader for uint8 NHWC image datasets.

    The Python ``Loader``'s iteration contract (``len``, ``set_epoch``,
    ``sampler``; yields (images, labels) numpy batches) with the
    reference's augmentation fused into the native pass.  Its random
    draws are the C++ worker's own (the JAX package's ``NativeLoader``'s
    exactly), not the Python ``Loader``'s.

    An epoch left early (a ``break``, a resume that consumes some
    batches and stops) parks the workers when its iterator is closed:
    the batches in flight are discarded and no thread keeps working.
    ``stop()`` (or garbage collection) tears the worker down.
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        shuffle: bool = True,
        sampler: Optional[ShardedSampler] = None,
        pad: int = 4,
        flip: bool = True,
        normalize: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None,
        num_threads: int = 4,
        queue_cap: int = 8,
        seed: int = 0,
        drop_last: bool = True,
    ):
        from ml_trainer_tpu_torch.data.sharded import (
            ShardedImageDataset,
            ShardedJpegDataset,
        )

        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._sampler = sampler
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._jpeg = isinstance(dataset, ShardedJpegDataset)
        # The C++ decode-error counter is cumulative over epochs: every
        # check compares against this baseline, taken at each epoch's
        # start, so that an early ``break`` never defers one epoch's
        # corrupt samples into a later epoch's raise.
        self._err_base = 0
        if self._jpeg:
            # Segments are the mapped JPEG byte blobs, located per sample
            # by each segment's offset table; pixels exist only for the
            # batches in flight.
            if len(dataset.shape) != 3 or dataset.shape[2] != 3:
                raise ValueError("jpeg NativeLoader requires HWC RGB")
            self._segments = list(dataset.byte_maps)
            self._offsets = [np.ascontiguousarray(o, np.int64)
                             for o in dataset.offset_tables]
            h, w, c = dataset.shape
            seg_starts = dataset.shard_starts[:-1]
        elif isinstance(dataset, ShardedImageDataset):
            # The worker gathers straight from the memory-mapped shards;
            # the references keep the mappings alive as long as it runs.
            if len(dataset.shape) != 3:
                raise ValueError("NativeLoader requires uint8 NHWC images")
            self._segments = [np.ascontiguousarray(m)
                              for m in dataset.shard_maps]
            h, w, c = dataset.shape
            seg_starts = dataset.shard_starts[:-1]
        else:
            if dataset.data.dtype != np.uint8 or dataset.data.ndim != 4:
                raise ValueError("NativeLoader requires uint8 NHWC image data")
            self._segments = [np.ascontiguousarray(dataset.data)]
            _, h, w, c = self._segments[0].shape
            seg_starts = [0]
        self._labels = np.ascontiguousarray(dataset.targets.astype(np.int32))
        self._shape = (h, w, c)
        if normalize is None:
            from ml_trainer_tpu_torch.utils.functions import (
                CIFAR10_MEAN,
                CIFAR10_STD,
            )

            normalize = (CIFAR10_MEAN, CIFAR10_STD)
        mean = (ctypes.c_float * c)(*normalize[0][:c])
        std = (ctypes.c_float * c)(*normalize[1][:c])
        lib = load_library()
        self._lib = lib
        n_segs = len(self._segments)
        seg_ptrs = (ctypes.c_void_p * n_segs)(
            *[s.ctypes.data for s in self._segments])
        starts = (ctypes.c_int64 * n_segs)(*[int(s) for s in seg_starts])
        common = (self._labels.ctypes.data_as(ctypes.c_void_p), len(dataset),
                  h, w, c, pad, int(flip), 1, mean, std, self.batch_size,
                  num_threads, queue_cap, seed + 1)
        if self._jpeg:
            off_ptrs = (ctypes.c_void_p * n_segs)(
                *[o.ctypes.data for o in self._offsets])
            self._handle = lib.batch_worker_create_jpeg(
                ctypes.cast(seg_ptrs, ctypes.POINTER(ctypes.c_void_p)),
                ctypes.cast(off_ptrs, ctypes.POINTER(ctypes.c_void_p)),
                ctypes.cast(starts, ctypes.POINTER(ctypes.c_int64)),
                n_segs, *common)
        else:
            self._handle = lib.batch_worker_create_sharded(
                ctypes.cast(seg_ptrs, ctypes.POINTER(ctypes.c_void_p)),
                ctypes.cast(starts, ctypes.POINTER(ctypes.c_int64)),
                n_segs, *common)
        if not self._handle:
            raise RuntimeError("native batch worker creation failed")

    @property
    def sampler(self):
        from ml_trainer_tpu_torch.data.loader import _TrivialSampler

        return self._sampler if self._sampler is not None else \
            _TrivialSampler(len(self.dataset))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self._sampler is not None:
            self._sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        if self._sampler is not None:
            return np.asarray(self._sampler.indices(), np.int64)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            return rng.permutation(len(self.dataset)).astype(np.int64)
        return np.arange(len(self.dataset), dtype=np.int64)

    def _start_epoch(self, idx: np.ndarray, n_batches: int) -> None:
        self._lib.batch_worker_start_epoch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_batches, self._epoch)

    def _park(self) -> None:
        """Schedule an empty epoch: the worker discards the batches in
        flight and its threads wait."""
        if getattr(self, "_handle", None):
            self._start_epoch(np.zeros(1, np.int64), 0)

    def __iter__(self):
        n_batches = len(self)
        need = n_batches * self.batch_size
        idx = self._indices().astype(np.int64, copy=False)
        if idx.size < need:
            # drop_last=False with a ragged tail: the worker copies
            # n_batches * batch_size indices, so pad by wrapping (the
            # ShardedSampler's convention) rather than hand it a short
            # buffer.  The final batch repeats leading samples.
            idx = np.resize(idx, need)
        idx = np.ascontiguousarray(idx[:need], np.int64)
        if self._handle is None:
            raise RuntimeError("NativeLoader used after stop()")
        if self._jpeg:
            # Errors left unobserved by an earlier epoch's early break
            # belong to that epoch (stop()/__del__ report them).
            self._err_base = self._lib.batch_worker_decode_errors(
                self._handle)
        self._start_epoch(idx, n_batches)
        finished = False
        try:
            h, w, c = self._shape
            for _ in range(n_batches):
                images = np.empty((self.batch_size, h, w, c), np.float32)
                labels = np.empty((self.batch_size,), np.int32)
                got = self._lib.batch_worker_next(
                    self._handle, images.ctypes.data_as(ctypes.c_void_p),
                    labels.ctypes.data_as(ctypes.c_void_p))
                if got < 0:
                    return
                yield images, labels
            finished = True
        finally:
            if not finished:
                self._park()
        errs = self._decode_error_delta()
        # The decode_error fault (resilience/faults.py): the same
        # accounting as a decode failure the C++ side counted.
        from ml_trainer_tpu_torch.resilience.faults import active_plan

        plan = active_plan()
        if plan is not None and plan.fire("decode_error",
                                          epoch=self._epoch) is not None:
            errs += 1
        if errs:
            # Corrupt streams were zero-filled to keep shapes; fail the
            # epoch rather than train on silent zeros.
            raise RuntimeError(
                f"{errs} sample(s) failed JPEG decode this epoch")

    def _decode_error_delta(self) -> int:
        """New decode errors since the last check (a delta against the
        cumulative C++ counter; consumes what it reports)."""
        if not self._jpeg or not getattr(self, "_handle", None):
            return 0
        errs = int(self._lib.batch_worker_decode_errors(self._handle))
        delta = errs - self._err_base
        self._err_base = errs
        return delta

    def stop(self) -> None:
        """Tear down the C++ worker now (idempotent).  Raises if decode
        errors accumulated since the last check: a consumer that broke
        out of an epoch early still hears of its corrupt samples."""
        handle = getattr(self, "_handle", None)
        if not handle:
            return
        errs = self._decode_error_delta()
        self._lib.batch_worker_destroy(handle)
        self._handle = None
        if errs:
            raise RuntimeError(
                f"{errs} sample(s) failed JPEG decode since the last check")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            errs = self._decode_error_delta()
            self._lib.batch_worker_destroy(handle)
            self._handle = None
            if errs:
                # Raising in __del__ is unraisable; warn instead.
                import warnings

                warnings.warn(
                    f"NativeLoader destroyed with {errs} unreported JPEG "
                    "decode error(s)")
