"""Port parity: the paged-attention decode's plain version (what the
wrapper runs for a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, at float32 atol/rtol 1e-5: trash pages, partial last
pages and length-1 rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_trainer_tpu.ops.kernels import paged_attention as j_paged
from ml_trainer_tpu_torch.ops.kernels import (
    paged_attention,
    paged_attention_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b, h, d, ps, P, lengths, trash_rows=()):
    rng = np.random.default_rng(seed)
    n_pages = b * P + 1
    q = (rng.normal(size=(b, h, d)) * 0.5).astype(np.float32)
    kp, vp = ((rng.normal(size=(n_pages, h, ps, d)) * 0.5).astype(np.float32)
              for _ in range(2))
    table = (1 + rng.permutation(n_pages - 1).reshape(b, P)).astype(np.int32)
    for r in trash_rows:
        table[r, 1:] = 0
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _both(q, kp, vp, table, lens):
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(lens),
                   implementation="pallas", interpret=True)
    got = paged_attention(*(torch.from_numpy(x)
                            for x in (q, kp, vp, table, lens)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("b,h,d,ps,P", [(3, 2, 8, 8, 2), (3, 4, 32, 16, 4)])
def test_paged_matches_jax_interpret(b, h, d, ps, P):
    """Full row, length 1 (only token 0 of the first page), partial last
    page."""
    lengths = [ps * P, 1, ps + 1]
    got, want = _both(*_case(0, b, h, d, ps, P, lengths))
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_trash_row_and_exact_pool():
    """Every non-trash page referenced once, and a row whose table is
    trash past its first page: the mask, not the table, decides."""
    case = _case(1, 4, 2, 16, 8, 3, [24, 24, 7, 1], trash_rows=(3,))
    got, want = _both(*case)
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_wrapper_takes_plain_on_cpu_and_checks_shapes():
    q, kp, vp, table, lens = (torch.from_numpy(x) for x in
                              _case(2, 2, 2, 8, 4, 2, [8, 3]))
    got = paged_attention(q, kp, vp, table, lens)
    want = paged_attention_reference(q, kp, vp, table, lens)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"\[B, H, D\]"):
        paged_attention(q[None], kp, vp, table, lens)
    with pytest.raises(ValueError, match="shapes differ"):
        paged_attention(q, kp, vp[:, :1], table, lens)
