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
its worker thread while other threads may synchronise or profile.
"""

from __future__ import annotations

import time

import torch

from ml_trainer_tpu_torch.device import CountedGraph
from ml_trainer_tpu_torch.parallel import comm_stats


class StepGraph:
    """One CUDA graph of ``fn(*inputs)`` on ``device``'s card."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
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
        self.inputs = [torch.empty_like(a) for a in args]
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as torch.cuda.graph does, before measuring
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
