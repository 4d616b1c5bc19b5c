"""Tracing for the port (the JAX package's ``utils/profiler.py``
``trace``): ``with trace(logdir): trainer.fit()`` records the region with
``torch.profiler`` (host and, where a card is visible, its kernels) and
writes ``<logdir>/trace.json``, a Chrome trace that Perfetto or
``chrome://tracing`` opens."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the ``with`` block; its trace is ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
