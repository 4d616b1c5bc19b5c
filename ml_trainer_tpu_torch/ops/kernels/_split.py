"""Split reductions: the ticket counters of the fixed-order merge.

K6 (paged attention) splits each row's positions over blocks; the last
block of the row to finish merges the partials in a fixed order
(``csrc/split_merge.cuh``).  It finds out that it is last from an integer
counter per row and head, which every launch leaves at 0.  The counters
live in one int32 buffer per (device, stream), zeroed once when it is
made; launches on one stream run in order, so they share it.

A CUDA graph replays the counters of the stream it was captured on: make
one call on that stream before the capture (the usual warm-up), since a
buffer cannot be made and zeroed while the stream is being captured.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (device index, stream handle) -> zeroed int32 counters.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
# Buffers replaced by larger ones: kept, since a launch still queued on
# their stream may use them.
_RETIRED: List[torch.Tensor] = []
_MIN_COUNTERS = 4096


def tickets(device: torch.device, stream: torch.cuda.Stream,
            n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for launches on ``stream``."""
    key = (device.index, stream.cuda_stream)
    buf = _TICKETS.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the split kernels' ticket counters for this stream do not exist "
            "yet and cannot be made during CUDA graph capture: make one call "
            "on the capture stream before capturing")
    if buf is not None:
        _RETIRED.append(buf)
    buf = torch.zeros(max(n, _MIN_COUNTERS), dtype=torch.int32, device=device)
    _TICKETS[key] = buf
    return buf


def all_zero() -> bool:
    """Whether every counter is back at 0 (synchronises)."""
    return all(int(buf.count_nonzero()) == 0 for buf in _TICKETS.values())
