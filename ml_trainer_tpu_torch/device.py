"""Device resolution and the kernels' launch counters.

Every entry point of the port (``Server``, ``SlotDecodeEngine``,
``generate``, ``Trainer``, the model constructors) resolves its device
here: the default is the CUDA card, and with no card the call raises
instead of quietly running on the CPU.  The CPU is used only when the
caller asks for it with ``device="cpu"`` (the parity tests do).

The launch counters are plain integers, one per hand-written kernel.
A kernel's wrapper adds one exactly where it launches the kernel, so a
run can show that its main path went through the kernels and not
through their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

# Kernel name -> launches since the last reset.
_LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "paged_attention": 0,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given.

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
    elif dev.type != "cpu":
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
