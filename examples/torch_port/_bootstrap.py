"""Shared bootstrap of the port's examples: put the repo root on
sys.path, and name the device the examples run on.

``python examples/torch_port/<name>.py`` puts only the script's own
directory on sys.path, so ``ml_trainer_tpu_torch`` would not resolve;
every example does ``import _bootstrap`` (this module lives next to
them, hence importable in exactly that situation, and under
``runpy.run_path`` too) and gets the repo root inserted once.

``BACKEND``: unset, the examples run on the CUDA card (and raise when
none is visible); ``BACKEND=cpu`` runs them on the CPU.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def device():
    """``"cpu"`` under ``BACKEND=cpu``, else ``"cuda"``."""
    return "cpu" if os.environ.get("BACKEND") == "cpu" else "cuda"
