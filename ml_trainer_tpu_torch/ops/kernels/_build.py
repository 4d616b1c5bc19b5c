"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ml_trainer_tpu_torch/csrc/`` becomes its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), compiled for ``sm_90a`` at first use into
``build/torch_kernels/`` at the root of the checkout.  A library's file
name carries a hash of its source, of every local header the source
includes with ``#include "..."`` (recursively), and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0, because a refused launch never runs
and a later synchronise does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
# Source name -> {C function: argument types}.
SIGNATURES: Dict[str, Dict[str, list]] = {
    # K1-K3: float32 (_f32) and bfloat16 (_bf16) entry points, alike.
    "flash_fwd": {
        # q, k, v, kv_lens|NULL, out, lse, bh, heads, s_q, s_k, d,
        # causal, scale, stream
        f"flash_fwd_{t}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P] for t in ("f32", "bf16")
    },
    "flash_bwd": {
        **{
            # q, k, v, kv_lens|NULL, dout, lse, delta, dq, bh, heads, s_q,
            # s_k, d, causal, scale, stream
            f"flash_bwd_dq_{t}": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _F, _P] for t in ("f32", "bf16")
        },
        **{
            # q, k, v, kv_lens|NULL, dout, lse, delta, dk, dv, bh, heads,
            # s_q, s_k, d, causal, scale, stream
            f"flash_bwd_dkv_{t}": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _F, _P]
            for t in ("f32", "bf16")
        },
    },
    "paged_attention": {
        # q, k_pool, v_pool, table, lengths, out, workspace|NULL,
        # tickets|NULL, batch, heads, pages, page_size, d, split, scale,
        # stream
        "paged_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _F, _P],
        # q, k_pool, v_pool, table, lengths, out, batch, heads, pages,
        # page_size, d, split, scale, stream
        "paged_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _F, _P],
    },
    "int8_matmul": {
        # x, w_q, scale, bias|NULL, out, m, k, n, slice, stream; x and out
        # float32 (_f32) or bfloat16 (_bf16)
        f"int8_matmul_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        for t in ("f32", "bf16")
    },
    "fused_adam": {
        # g[], out[], n[], chunk0[], sharded[], n_leaves, chunk,
        # denom_ptr|NULL, denom, partials, leaf_sq, sq, compute_sq,
        # accumulate, stream
        "unscale_sqsum_list_f32": [_P, _P, _P, _P, _P, _I, _L, _P, _F, _P,
                                   _P, _P, _I, _I, _P],
        # ptrs[8][n_leaves], n[], chunk0[], n_leaves, chunk, scalars,
        # has_factor, stream
        "fused_adam_list_f32": [_P, _P, _P, _I, _L, _P, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# Build log: name -> {"seconds", "cached", "ptxas": nvcc's report lines}.
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(path: Path, seen: Optional[list] = None) -> list:
    """``path`` and every local header it includes with ``#include "..."``,
    recursively, each once, in the order first reached.  A header is
    looked up beside the file that includes it, as ``nvcc`` does; one that
    is not there is left to ``nvcc`` to report."""
    seen = [] if seen is None else seen
    path = path.resolve()
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.is_file():
            _sources(dep, seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in _sources(CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _tmp_path(name: str) -> Path:
    return _lib_path(name).with_suffix(f".{os.getpid()}.tmp")


def _start(name: str) -> Optional[subprocess.Popen]:
    if _lib_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *FLAGS, "-o", str(_tmp_path(name)),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen], t0: float) -> None:
    out, tmp = _lib_path(name), _tmp_path(name)
    if proc is None:
        BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": []}
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0,
        "cached": False,
        # -Xptxas -v: registers, shared memory, stack and spills per kernel.
        "ptxas": [ln.strip() for ln in log.splitlines() if ln.strip()],
    }


def build_all() -> Dict[str, dict]:
    """Build every kernel library at once (one ``nvcc`` per source) and
    load them; returns ``BUILD_LOG``."""
    names = list(SIGNATURES)
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    for n in names:
        _finish(n, procs[n], t0)
    for n in names:
        load(n)
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not _lib_path(name).exists():
        t0 = time.perf_counter()
        _finish(name, _start(name), t0)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {what} failed to launch: cudaError {status}"
        )
