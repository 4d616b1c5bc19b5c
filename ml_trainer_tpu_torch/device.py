"""Device resolution and the kernels' launch counters.

Every entry point of the port (``Server``, ``SlotDecodeEngine``,
``generate``, ``Trainer``, the model constructors) resolves its device
here: the default is the CUDA card, and with no card the call raises
instead of quietly running on the CPU.  The CPU is used only when the
caller asks for it with ``device="cpu"`` (the parity tests do).

The launch counters are plain integers, one per hand-written kernel.
A kernel's wrapper adds one exactly where it launches the kernel, so a
run can show that its main path went through the kernels and not
through their plain PyTorch versions.  Under a CUDA graph a wrapper runs
once, at capture, and its kernel on every replay: ``CountedGraph`` moves
the capture's counts to the replays.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Union

import torch

# Kernel name -> launches since the last reset.
_LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "paged_attention": 0, "int8_matmul": 0, "unscale_sqsum": 0,
    "fused_adam": 0,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given
    ("meta" too: a model built without storage, ``GPT2.clone``'s).

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible: the port never falls back to the
    CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        # float32 matmuls in full float32 (PyTorch's default, stated
        # here so that no caller's setting changes the model's numbers):
        # the model serves in fp32, as the JAX reference does.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's deterministic convolution algorithms, none picked by
        # timing: the default backward adds with atomics, so two runs of
        # a conv model would differ, where the JAX programs repeat bit
        # for bit (and a resumed run must end where the uninterrupted
        # one does).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def check_model_device(model: torch.nn.Module, device) -> torch.device:
    """Resolve ``device`` and require the model's weights to live there."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type:
        raise ValueError(
            f"model weights live on {have}, but the call runs on {dev}; "
            "move the model or pass the matching device"
        )
    return have


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


class CountedGraph:
    """A CUDA graph and what its capture added to the launch counters.

    A capture launches nothing, but the wrappers it runs count their
    launches.  ``capturing()`` takes back what the capture added to the
    counters, and to each dict of ``tallies`` (name -> number: the
    collectives' accounting), and keeps it; ``replay()`` replays the
    graph and adds it again, so that ``launch_counts()`` stays the number
    of launches that ran.  ``graph``: a ``torch.cuda.CUDAGraph``, or
    anything with a ``replay()``."""

    def __init__(self, graph, tallies: Sequence[dict] = ()):
        self.graph = graph
        self.tallies = [_LAUNCHES, *tallies]
        self.added: list = [{} for _ in self.tallies]

    @contextlib.contextmanager
    def capturing(self):
        before = [dict(t) for t in self.tallies]
        try:
            yield self.graph
        finally:
            for tally, old, added in zip(self.tallies, before, self.added):
                added.clear()
                added.update({k: v - old.get(k, 0) for k, v in tally.items()
                              if v != old.get(k, 0)})
                tally.clear()
                tally.update(old)

    def replay(self) -> None:
        self.graph.replay()
        for tally, added in zip(self.tallies, self.added):
            for k, n in added.items():
                tally[k] = tally.get(k, 0) + n
