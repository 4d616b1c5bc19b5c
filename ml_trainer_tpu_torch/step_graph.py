"""One CUDA graph of a step: K training (or evaluation) steps, the port's
counterpart of the JAX package's ``lax.scan`` over batches stacked to
[K, B, ...] (``steps_per_execution``), or the serving engine's decode
step, the counterpart of its ``jax.jit`` decode program
(``serving/engine.py``).

A graph reads and writes fixed addresses.  So it owns input buffers of
the chunk's shapes, and each replay starts with a ``copy_`` of the chunk
into them; the captured steps write the training state back into the
tensors that hold it (``Trainer._train_step_in_place``); the outputs,
the chunk's summed loss and metric, live in the graph's memory and the
next replay overwrites them, so the caller adds them to its sums on the
same stream first.

The first chunk runs ``fn`` for real on the capture's side stream
(``warm_up``): that builds the kernels, creates the cuBLAS handles and
autograd's state, none of which may happen during a capture, and moves
the trajectory as an eager chunk would.  The capture executes nothing,
but it runs the steps' Python: the launch counters and the collectives'
accounting are moved to the replays (``device.CountedGraph``), and the
caller undoes its own side effects (the host step count).

The capture prohibits unsafe CUDA calls on its own thread only
(``capture_error_mode="thread_local"``): the serving engine captures on
its worker thread while other threads launch work on their own streams.
A device-wide synchronise is refused while any stream of the device is
capturing, and the replicas of an in-process router each capture on
their own loop thread: so a capture (with the synchronise and the cache
release before it) and ``synchronize`` below hold one process-wide lock
(``_DEVICE_WIDE``).

torch keeps a cuBLAS workspace for every (handle, stream) pair it has
met, for the life of the process: on the H100 a server whose graph took
a new stream left 34.6 MB allocated after its close.  So a graph takes
its side stream from ``take_stream``, and the serving engine hands it
back with ``give_back_stream`` when it closes: each new engine reuses a
stream, and the card's memory stays flat however many servers a
process makes in turn.
"""

from __future__ import annotations

import threading
import time

import torch

from ml_trainer_tpu_torch.device import CountedGraph
from ml_trainer_tpu_torch.parallel import comm_stats


# Held by a capture and by every device-wide synchronise of the serving
# path: no two captures, and no synchronise during one.
_DEVICE_WIDE = threading.RLock()


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)``, never during another thread's
    capture."""
    with _DEVICE_WIDE:
        torch.cuda.synchronize(device)


# Side streams that closed graphs gave back, by device.
_FREE_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def take_stream(device):
    """A side stream for a graph on ``device``: one given back, else a
    new one."""
    with _STREAMS_LOCK:
        free = _FREE_STREAMS.get(str(device))
        if free:
            return free.pop()
    return torch.cuda.Stream(device)


def give_back_stream(device, stream) -> None:
    """Return ``stream`` for the next graph on ``device`` (its work
    must be finished)."""
    with _STREAMS_LOCK:
        _FREE_STREAMS.setdefault(str(device), []).append(stream)


class StepGraph:
    """One CUDA graph of ``fn(*inputs)`` on ``device``'s card, warmed up
    and captured on a side stream from ``take_stream``."""

    def __init__(self, device):
        self.device = device
        self.stream = take_stream(device)
        self.graph = CountedGraph(torch.cuda.CUDAGraph(),
                                  comm_stats.tallies())
        self.inputs: list = []
        self.out = None
        self.capture_s = None  # host seconds the capture took
        # Device bytes the capture added: allocated (the outputs the graph
        # keeps) and reserved (its memory pool).
        self.capture_bytes = None

    def warm_up(self, fn, *args):
        """``fn(*args)``, run for real on the capture's side stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        current.wait_stream(self.stream)
        return out

    def capture(self, fn, *args) -> None:
        """Capture ``fn`` on buffers shaped as ``args`` (their values are
        not read: the capture runs nothing)."""
        t0 = time.perf_counter()
        with _DEVICE_WIDE:
            self.inputs = [torch.empty_like(a) for a in args]
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()  # as torch.cuda.graph does, first
            before = (torch.cuda.memory_allocated(self.device),
                      torch.cuda.memory_reserved(self.device))
            with self.graph.capturing(), torch.cuda.graph(
                    self.graph.graph, stream=self.stream,
                    capture_error_mode="thread_local"):
                self.out = fn(*self.inputs)
        self.capture_s = time.perf_counter() - t0
        self.capture_bytes = {
            "allocated": torch.cuda.memory_allocated(self.device) - before[0],
            "reserved": torch.cuda.memory_reserved(self.device) - before[1]}

    def replay(self, *args):
        """``fn(*args)`` as one replay; the outputs are the graph's own
        tensors, valid until the next replay."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        return self.out
