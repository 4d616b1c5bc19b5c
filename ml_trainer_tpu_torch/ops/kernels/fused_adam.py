"""Fused unscale + clip + Adam for the ``dp_update="sharded"`` optimizer
tail (the JAX package's ``ops/kernels/fused_adam.py``).

The sharded step's tail over each replica's 1/N dim-0 shard is many
small passes over the same bytes: unscale, the squared norm for the
global clip, the clip multiply, two moment updates, the bias
corrections, the schedule step, ``lr_scale`` and the parameter write.
Two kernels do it in two passes (the global-norm sum over replicas
between them is a barrier), ``csrc/fused_adam.cu``:

* K4, ``unscale_sqsum``: ``g / denom`` and the float32 sum of the
  squared quotient in one read of ``g``;
* K5, ``fused_adam_update``: clip multiply, Adam's moments, bias
  corrections, schedule step, ``lr_scale`` and the parameter write in
  one read of (g, p, mu, nu) and one write of (p', mu', nu', u).

Numbers.  The plain versions follow the JAX package's op order
(``fused_adam.py:91-95`` and ``:185-196``), which is also the port's
unfused chain (``ops/optimizers.py``: ``chain(identity(), adam(sched))``
with the trainer's ``u * lr_scale`` and ``p + u``), so on the CPU the
fused tail is bitwise the unfused one.  K5 makes each operation its own
float32 rounding and reads the same five scalars, so it is bitwise its
plain version on the card.  K4's quotient is an IEEE division on both
sides (the plain version divides by a device scalar: PyTorch multiplies
by the reciprocal when the divisor is a Python number on a CUDA tensor);
its sum is taken in another order than ``torch.sum``, so it agrees to
float32 rounding, and it is deterministic (no float atomics).

The JAX kernel runs ``unscale_sqsum`` as one VMEM block and falls back
to its reference above 2 M elements; that is the TPU's limit and is not
carried over: K4 launches for every leaf on the card.

Dispatch (every function here): ``implementation="auto"`` launches the
kernel for a CUDA tensor and takes the plain version for a CPU tensor;
``"reference"`` takes the plain version on either device.  The kernels
take float32 only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ml_trainer_tpu_torch.device import count_launch

# optax.adam's defaults: the only configuration the fused tail accepts
# (the trainer gates on optimizer="adam" with weight_decay=0).
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

_INT32_MAX = 2 ** 31 - 1
_SQ_PARTIALS = 1024  # K4's per-block partial sums (kSqBlocks in the source)


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


# --------------------------------------------------------- unscale+sqsum
def unscale_sqsum_reference(g: torch.Tensor, denom, compute_sq: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: ``(g / denom, sum(square(f32(g / denom))))``."""
    g_u = torch.div(g, _scalar(denom, g.device))
    if not compute_sq:
        return g_u, None
    return g_u, torch.sum(torch.square(g_u.to(torch.float32)))


def _unscale_kernel(g, denom, compute_sq):
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_f32("unscale_sqsum", g)
    if g.numel() == 0:  # an empty leaf: nothing to launch
        return unscale_sqsum_reference(g, denom, compute_sq)
    g_c = g.contiguous()
    out = torch.empty_like(g_c)
    partials = torch.empty(_SQ_PARTIALS, dtype=torch.float32, device=g.device)
    sq = torch.empty((), dtype=torch.float32, device=g.device)
    d_ptr, d_imm = None, 0.0
    if isinstance(denom, torch.Tensor):
        d_t = _scalar(denom, g.device).contiguous()
        d_ptr = d_t.data_ptr()
    else:
        d_imm = float(denom)
    lib = load("fused_adam")
    count_launch("unscale_sqsum")
    check(lib.unscale_sqsum_f32(
        g_c.data_ptr(), d_ptr, d_imm, out.data_ptr(), partials.data_ptr(),
        sq.data_ptr(), g_c.numel(), int(compute_sq),
        torch.cuda.current_stream(g.device).cuda_stream,
    ), "unscale_sqsum_f32")
    return out.view(g.shape), (sq if compute_sq else None)


def unscale_sqsum(g: torch.Tensor, denom, *, compute_sq: bool = True,
                  implementation: str = "auto"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(g / denom, sum(square(f32(g / denom))))`` in one pass.

    ``denom`` is a Python number or a float32 device scalar (a
    loss-scaled denominator); the division is IEEE either way.
    ``compute_sq=False`` skips the sum (no clip) and returns ``None``
    for it."""
    if _dispatch("unscale_sqsum", implementation, g.device):
        return _unscale_kernel(g, denom, compute_sq)
    return unscale_sqsum_reference(g, denom, compute_sq)


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


def _adam_kernel(g, p, mu, nu, bc1, bc2, step_size, lr_scale, factor):
    from ml_trainer_tpu_torch.ops.kernels._build import check, load

    _check_f32("fused_adam", g, p, mu, nu)
    if not g.shape == p.shape == mu.shape == nu.shape:
        raise ValueError(
            f"fused_adam: shapes differ: g {tuple(g.shape)}, p "
            f"{tuple(p.shape)}, mu {tuple(mu.shape)}, nu {tuple(nu.shape)}")
    if g.numel() == 0:  # an empty leaf: nothing to launch
        return fused_adam_update_reference(g, p, mu, nu, bc1, bc2, step_size,
                                           lr_scale, factor)
    dev = g.device
    has_factor = factor is not None
    scalars = torch.stack([_scalar(v, dev) for v in (
        bc1, bc2, step_size, lr_scale, factor if has_factor else 1.0)])
    g, p, mu, nu = (t.contiguous() for t in (g, p, mu, nu))
    outs = [torch.empty_like(p) for _ in range(4)]
    lib = load("fused_adam")
    count_launch("fused_adam")
    check(lib.fused_adam_f32(
        scalars.data_ptr(), g.data_ptr(), p.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), *(o.data_ptr() for o in outs), g.numel(),
        int(has_factor), torch.cuda.current_stream(dev).cuda_stream,
    ), "fused_adam_f32")
    return tuple(outs)


def fused_adam_update(g, p, mu, nu, *, bc1, bc2, step_size, lr_scale,
                      factor=None, implementation: str = "auto"):
    """One fused pass of the optimizer tail over one leaf shard; returns
    ``(p', mu', nu', u)`` with ``u`` the applied update.  ``bc1``,
    ``bc2``, ``step_size`` come from :func:`adam_scalars`; ``factor`` is
    the clip factor, or ``None`` when no clip is configured (the multiply
    is then left out, as in the unfused path)."""
    if _dispatch("fused_adam_update", implementation, g.device):
        return _adam_kernel(g, p, mu, nu, bc1, bc2, step_size, lr_scale,
                            factor)
    return fused_adam_update_reference(g, p, mu, nu, bc1, bc2, step_size,
                                       lr_scale, factor)
