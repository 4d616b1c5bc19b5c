"""Fused unscale + clip + Adam for the ``dp_update="sharded"`` optimizer
tail (the JAX package's ``ops/kernels/fused_adam.py``).

The sharded step's tail over each replica's 1/N dim-0 shard is many
small passes over the same bytes: unscale, the squared norm for the
global clip, the clip multiply, two moment updates, the bias
corrections, the schedule step, ``lr_scale`` and the parameter write.
Two kernels do it in two passes (the global-norm sum over replicas
between them is a barrier), ``csrc/fused_adam.cu``, each ONE launch over
a list of leaves (a replica's whole list in the sharded step):

* K4, ``unscale_sqsum_list``: ``g / denom`` for every leaf and the
  float32 sum of each leaf's squared quotient in one read of ``g``, the
  leaves' sums added in leaf order into ``sq_loc`` (sharded leaves) and
  ``sq_rep`` (replicated ones);
* K5, ``fused_adam_update_list``: clip multiply, Adam's moments, bias
  corrections, schedule step, ``lr_scale`` and the parameter write in
  one read of (g, p, mu, nu) and one write of (p', mu', nu', u) per leaf.

``unscale_sqsum`` and ``fused_adam_update`` are the one-leaf case of
the same kernels.  The launch cuts every leaf into chunks of ``CHUNK``
elements and gives each chunk a block (``chunk_table``); a list longer
than a launch's table (``K4_MAX_LEAVES``, ``K5_MAX_LEAVES``) goes out as
several launches of the same kernel, in leaf order (``launch_groups``).
Each launch allocates one flat buffer per output kind, and the leaves
come back as views of it (``flat_views``: every leaf at a 16-byte
aligned offset).

Numbers.  The plain versions follow the JAX package's op order
(``fused_adam.py:91-95`` and ``:185-196``), which is also the port's
unfused chain (``ops/optimizers.py``: ``chain(identity(), adam(sched))``
with the trainer's ``u * lr_scale`` and ``p + u``), so on the CPU the
fused tail is bitwise the unfused one; the list plain versions are the
per-leaf ones in a loop, the sums added in leaf order.  K5 makes each
operation its own float32 rounding and reads the same five scalars, so
it is bitwise its plain version on the card.  K4's quotient is an IEEE
division on both sides (the plain version divides by a device scalar:
PyTorch multiplies by the reciprocal when the divisor is a Python number
on a CUDA tensor); its sums are taken in another order than
``torch.sum`` (within a chunk by thread, then the chunks of a leaf in
chunk order, then the leaves in leaf order: the source's header), so
they agree to float32 rounding, and they are deterministic (no float
atomics).

The JAX kernel runs ``unscale_sqsum`` as one VMEM block and falls back
to its reference above 2 M elements; that is the TPU's limit and is not
carried over: K4 takes every leaf on the card.

Dispatch (every function here): ``implementation="auto"`` launches the
kernel for CUDA tensors and takes the plain version for CPU tensors;
``"reference"`` takes the plain version on either device.  The kernels
take float32 only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ml_trainer_tpu_torch.device import count_launch

# optax.adam's defaults: the only configuration the fused tail accepts
# (the trainer gates on optimizer="adam" with weight_decay=0).
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

_INT32_MAX = 2 ** 31 - 1
CHUNK = 16384        # elements a block takes (the kernels' ``chunk``)
K4_MAX_LEAVES = 512  # leaves a launch's table holds (kUnscaleLeaves and
K5_MAX_LEAVES = 256  # kAdamLeaves in the source)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_int32_increment``: ``count + 1``, saturating."""
    return torch.where(count < _INT32_MAX, count + 1,
                       torch.full_like(count, _INT32_MAX))


def adam_scalars(count: torch.Tensor, sched_count: torch.Tensor,
                 lr_schedule):
    """The per-step scalars every leaf shares, as device tensors (no host
    read): ``(count_inc, bc1, bc2, step_size, sched_inc)`` with
    ``bc = 1 - b ** count_inc`` and ``step_size = -lr(sched_count)`` at
    the PRE-increment schedule count."""
    count_inc = _safe_increment(count)
    bc1 = 1.0 - torch.pow(B1, count_inc.to(torch.float32))
    bc2 = 1.0 - torch.pow(B2, count_inc.to(torch.float32))
    if callable(lr_schedule):
        step_size = -lr_schedule(sched_count)
    else:
        step_size = torch.full((), -1.0 * lr_schedule, dtype=torch.float32,
                               device=count.device)
    return count_inc, bc1, bc2, step_size, _safe_increment(sched_count)


def _scalar(value, device) -> torch.Tensor:
    """A 0-dim float32 tensor on ``device`` (a Python number is filled on
    the device, not copied from the host)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _dispatch(name: str, implementation: str, device: torch.device) -> bool:
    """True for the kernel, False for the plain version."""
    if implementation == "reference":
        return False
    if implementation != "auto":
        raise ValueError(f"Unknown {name} implementation {implementation!r}")
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu, not {device}")


def _check_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")


# ------------------------------------------------------------ work table
def chunk_table(sizes: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """``chunk0`` of a list of leaves of ``sizes`` elements: leaf ``l``
    owns chunks ``[chunk0[l], chunk0[l + 1])``, ``ceil(n / chunk)`` of
    them (an empty leaf none); chunk ``c`` of leaf ``l`` covers elements
    ``[(c - chunk0[l]) * chunk, ...)`` of it, at most ``chunk``."""
    counts = -(-np.asarray(sizes, dtype=np.int64) // chunk)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def launch_groups(n_leaves: int, max_leaves: int) -> List[Tuple[int, int]]:
    """The launches of a list of ``n_leaves``: ``[lo, hi)`` ranges of at
    most ``max_leaves`` leaves, in leaf order."""
    return [(lo, min(lo + max_leaves, n_leaves))
            for lo in range(0, n_leaves, max_leaves)]


def flat_views(shapes: Sequence[torch.Size], kinds: int,
               device) -> List[List[torch.Tensor]]:
    """``kinds`` flat float32 buffers, each cut into one view per leaf of
    ``shapes``, every view at a multiple of 4 elements (16 bytes) into its
    buffer, so that the kernels' vector path depends on the inputs
    alone."""
    layout, off = [], 0  # (shape, contiguous strides, offset) per leaf
    for shape in shapes:
        strides, n = [], 1
        for d in reversed(shape):
            strides.append(n)
            n *= d
        layout.append((shape, strides[::-1], off))
        off += n + (-n % 4)
    out = []
    for _ in range(kinds):
        flat = torch.empty(off, dtype=torch.float32, device=device)
        out.append([flat.as_strided(*leaf) for leaf in layout])
    return out


def _ptrs(tensors) -> np.ndarray:
    return np.array([t.data_ptr() for t in tensors], dtype=np.uint64)


# --------------------------------------------------------- unscale+sqsum
def unscale_sqsum_reference(g: torch.Tensor, denom, compute_sq: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: ``(g / denom, sum(square(f32(g / denom))))``."""
    g_u = torch.div(g, _scalar(denom, g.device))
    if not compute_sq:
        return g_u, None
    return g_u, torch.sum(torch.square(g_u.to(torch.float32)))


def unscale_sqsum_list_reference(gs: Sequence[torch.Tensor], denom, *,
                                 sharded: Sequence[bool],
                                 compute_sq: bool = True):
    """Plain version of :func:`unscale_sqsum_list`: the per-leaf plain
    version in a loop, the sums added in leaf order (the trainer's
    unfused chain)."""
    outs, sums = [], []
    loc = rep = None
    if compute_sq:
        dev = gs[0].device
        loc = torch.zeros((), dtype=torch.float32, device=dev)
        rep = torch.zeros((), dtype=torch.float32, device=dev)
    for g, sh in zip(gs, sharded, strict=True):
        g_u, s = unscale_sqsum_reference(g, denom, compute_sq)
        outs.append(g_u)
        if compute_sq:
            sums.append(s)
            loc, rep = (loc + s, rep) if sh else (loc, rep + s)
    return outs, (sums if compute_sq else None), (loc, rep)


def _unscale_list_kernel(gs, denom, sharded, compute_sq):
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_f32("unscale_sqsum", *gs)
    if len(sharded) != len(gs):
        raise ValueError(f"unscale_sqsum: {len(gs)} leaves, "
                         f"{len(sharded)} sharded flags")
    sizes = [g.numel() for g in gs]
    if not any(sizes):  # nothing to launch
        return unscale_sqsum_list_reference(gs, denom, sharded=sharded,
                                            compute_sq=compute_sq)
    dev, n_leaves = gs[0].device, len(gs)
    gs = [g.contiguous() for g in gs]
    (outs,) = flat_views([g.shape for g in gs], 1, dev)
    chunk0 = chunk_table(sizes)
    chunks = int(chunk0[-1])
    # One scratch buffer: the chunks' partials, the leaves' sums, and
    # [sq_loc, sq_rep].
    scratch = torch.empty(chunks + n_leaves + 2 if compute_sq else 0,
                          dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    d_ptr, d_imm = None, 0.0
    if isinstance(denom, torch.Tensor):
        d_t = _scalar(denom, dev).contiguous()
        d_ptr = d_t.data_ptr()
    else:
        d_imm = float(denom)
    g_ptrs, o_ptrs = _ptrs(gs), _ptrs(outs)
    n_arr = np.asarray(sizes, dtype=np.int64)
    flags = np.asarray(sharded, dtype=np.uint8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = load("fused_adam")
    for lo, hi in launch_groups(n_leaves, K4_MAX_LEAVES):
        c0 = (chunk0[lo:hi + 1] - chunk0[lo]).astype(np.int32)
        count_launch("unscale_sqsum")
        check(lib.unscale_sqsum_list_f32(
            g_ptrs[lo:].ctypes.data, o_ptrs[lo:].ctypes.data,
            n_arr[lo:].ctypes.data, c0.ctypes.data, flags[lo:].ctypes.data,
            hi - lo, CHUNK, d_ptr, d_imm,
            base + 4 * int(chunk0[lo]) if compute_sq else None,
            base + 4 * (chunks + lo) if compute_sq else None,
            base + 4 * (chunks + n_leaves) if compute_sq else None,
            int(compute_sq), int(lo > 0), stream,
        ), "unscale_sqsum_list_f32")
    if not compute_sq:
        return outs, None, (None, None)
    leaf_sq = scratch[chunks:chunks + n_leaves].unbind()
    return outs, list(leaf_sq), (scratch[-2], scratch[-1])


def unscale_sqsum_list(gs: Sequence[torch.Tensor], denom, *,
                       sharded: Sequence[bool], compute_sq: bool = True,
                       implementation: str = "auto"):
    """K4 over a list of leaves in one launch: returns ``(outs, sums,
    (sq_loc, sq_rep))`` with ``outs[l] = gs[l] / denom``, ``sums[l]`` the
    float32 sum of ``outs[l] ** 2``, and the sums added in leaf order into
    ``sq_loc`` where ``sharded[l]`` and ``sq_rep`` elsewhere.

    ``denom`` is a Python number or a float32 device scalar (a
    loss-scaled denominator); the division is IEEE either way.
    ``compute_sq=False`` skips the sums (no clip) and returns ``(outs,
    None, (None, None))``."""
    gs = list(gs)
    if not gs:
        raise ValueError("unscale_sqsum_list: the list of leaves is empty")
    if _dispatch("unscale_sqsum", implementation, gs[0].device):
        return _unscale_list_kernel(gs, denom, list(sharded), compute_sq)
    return unscale_sqsum_list_reference(gs, denom, sharded=sharded,
                                        compute_sq=compute_sq)


def unscale_sqsum(g: torch.Tensor, denom, *, compute_sq: bool = True,
                  implementation: str = "auto"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(g / denom, sum(square(f32(g / denom))))`` in one pass: the
    one-leaf case of :func:`unscale_sqsum_list` (``None`` for the sum
    with ``compute_sq=False``)."""
    outs, sums, _ = unscale_sqsum_list([g], denom, sharded=[True],
                                       compute_sq=compute_sq,
                                       implementation=implementation)
    return outs[0], (sums[0] if compute_sq else None)


# ------------------------------------------------- clip + Adam + write
def fused_adam_update_reference(g, p, mu, nu, bc1, bc2, step_size, lr_scale,
                                factor=None):
    """Plain version of one fused pass: ``(p', mu', nu', u)``."""
    dev = g.device
    if factor is not None:
        g = g * _scalar(factor, dev)
    mu_n = (1 - B1) * g + B1 * mu
    nu_n = (1 - B2) * (g * g) + B2 * nu
    mu_hat = mu_n / _scalar(bc1, dev)
    nu_hat = nu_n / _scalar(bc2, dev)
    u = mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS)
    u = _scalar(step_size, dev) * u
    u = u * _scalar(lr_scale, dev)
    return p + u, mu_n, nu_n, u


def fused_adam_update_list_reference(gs, ps, mus, nus, *, bc1, bc2,
                                     step_size, lr_scale, factor=None):
    """Plain version of :func:`fused_adam_update_list`: the per-leaf
    plain version in a loop; returns ``(ps', mus', nus', us)``."""
    outs = ([], [], [], [])
    for leaf in zip(gs, ps, mus, nus, strict=True):
        for kind, t in zip(outs, fused_adam_update_reference(
                *leaf, bc1, bc2, step_size, lr_scale, factor)):
            kind.append(t)
    return outs


def _adam_list_kernel(gs, ps, mus, nus, bc1, bc2, step_size, lr_scale,
                      factor):
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    if not len(gs) == len(ps) == len(mus) == len(nus):
        raise ValueError(
            f"fused_adam: list lengths differ: g {len(gs)}, p {len(ps)}, "
            f"mu {len(mus)}, nu {len(nus)}")
    for g, p, mu, nu in zip(gs, ps, mus, nus):
        _check_f32("fused_adam", gs[0], g, p, mu, nu)
        if not g.shape == p.shape == mu.shape == nu.shape:
            raise ValueError(
                f"fused_adam: shapes differ: g {tuple(g.shape)}, p "
                f"{tuple(p.shape)}, mu {tuple(mu.shape)}, nu "
                f"{tuple(nu.shape)}")
    sizes = [g.numel() for g in gs]
    if not any(sizes):  # nothing to launch
        return fused_adam_update_list_reference(
            gs, ps, mus, nus, bc1=bc1, bc2=bc2, step_size=step_size,
            lr_scale=lr_scale, factor=factor)
    dev, n_leaves = gs[0].device, len(gs)
    has_factor = factor is not None
    scalars = torch.stack([_scalar(v, dev) for v in (
        bc1, bc2, step_size, lr_scale, factor if has_factor else 1.0)])
    ins = [[t.contiguous() for t in kind] for kind in (gs, ps, mus, nus)]
    outs = flat_views([g.shape for g in gs], 4, dev)
    ptrs = np.stack([_ptrs(kind) for kind in ins + outs])  # [8, leaves]
    chunk0 = chunk_table(sizes)
    n_arr = np.asarray(sizes, dtype=np.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = load("fused_adam")
    for lo, hi in launch_groups(n_leaves, K5_MAX_LEAVES):
        group = np.ascontiguousarray(ptrs[:, lo:hi])
        c0 = (chunk0[lo:hi + 1] - chunk0[lo]).astype(np.int32)
        count_launch("fused_adam")
        check(lib.fused_adam_list_f32(
            group.ctypes.data, n_arr[lo:].ctypes.data, c0.ctypes.data,
            hi - lo, CHUNK, scalars.data_ptr(), int(has_factor), stream,
        ), "fused_adam_list_f32")
    return tuple(outs)


def fused_adam_update_list(gs, ps, mus, nus, *, bc1, bc2, step_size,
                           lr_scale, factor=None,
                           implementation: str = "auto"):
    """K5 over a list of leaves in one launch; returns the four lists
    ``(ps', mus', nus', us)`` with ``us`` the applied updates.  ``bc1``,
    ``bc2``, ``step_size`` come from :func:`adam_scalars`; ``factor`` is
    the clip factor, or ``None`` when no clip is configured (the multiply
    is then left out, as in the unfused path).  The outputs must not
    alias the inputs."""
    gs = list(gs)
    if not gs:
        raise ValueError("fused_adam_update_list: the list of leaves is "
                         "empty")
    kw = dict(bc1=bc1, bc2=bc2, step_size=step_size, lr_scale=lr_scale,
              factor=factor)
    if _dispatch("fused_adam_update", implementation, gs[0].device):
        return _adam_list_kernel(gs, list(ps), list(mus), list(nus), **kw)
    return fused_adam_update_list_reference(gs, ps, mus, nus, **kw)


def fused_adam_update(g, p, mu, nu, *, bc1, bc2, step_size, lr_scale,
                      factor=None, implementation: str = "auto"):
    """One fused pass of the optimizer tail over one leaf shard, the
    one-leaf case of :func:`fused_adam_update_list`; returns ``(p', mu',
    nu', u)``."""
    outs = fused_adam_update_list(
        [g], [p], [mu], [nu], bc1=bc1, bc2=bc2, step_size=step_size,
        lr_scale=lr_scale, factor=factor, implementation=implementation)
    return tuple(kind[0] for kind in outs)
