"""Port parity: the list entry points of K4 (``unscale_sqsum_list``) and
K5 (``fused_adam_update_list``), one launch over a replica's whole list
of leaves, on the CPU.

Inputs are made with numpy from a seed, over GPT-2 tiny's leaves (vocab
1021, so that ``tok_embed``'s dim 0 is odd and it is replicated, as in
GPT-2 124M) split as ``plan_grad_buckets`` splits them at n = 2: each
replica's dim-0 shard of a sharded leaf, the whole of a replicated one.
Bars:

* the list plain versions against the trainer's unfused chain (per-leaf
  ``torch.div`` and ``torch.sum(torch.square(.))`` with the sums added in
  leaf order; ``chain(identity(), adam(sched))`` with ``u * lr_scale``
  and ``p + u``): bitwise;
* the same lists against the JAX package's per-leaf kernels run with
  ``implementation="pallas", interpret=True`` under ``jax.jit``, the
  leaves' sums added in leaf order as the JAX trainer adds them:
  quotients bitwise, ``sq_loc``/``sq_rep`` rtol 1e-6, K5's four outputs
  rtol 1e-6 with 1e-6 of the output's largest entry as the absolute bar
  (``tests/test_torch_fused_adam.py`` says why);
* the work table: every element of every leaf in exactly one chunk, in
  leaf order, and the launches' groups in leaf order;
* a numpy emulation of K4's sum order (by thread within a chunk, a
  shuffle tree, the warps in order; then a leaf's chunks by lane in
  chunk order and a shuffle tree; then the leaves in leaf order) within
  1e-6 relative of the plain per-leaf sums;
* the kernels' wrappers driven through that emulation in place of the
  built library (CPU tensors, raw pointers): the table, the group
  offsets and the output views as the card gets them; quotients and K5
  bitwise the plain versions, the sums bitwise the emulation;
* the edge cases: an empty leaf, a list of one leaf, a view that starts
  at an odd element offset (which takes the scalar loop alone).

``test_list_kernels_match_the_emulated_order_on_card`` needs an NVIDIA
card and nvcc (marker ``cuda``) and skips here.
"""

import ctypes
import importlib
import importlib.util

import numpy as np
import pytest
import torch

import ml_trainer_tpu_torch as mt
from ml_trainer_tpu_torch.ops import optimizers as topt
from ml_trainer_tpu_torch.ops.kernels import _build
from ml_trainer_tpu_torch.ops.kernels import fused_adam as fa
from ml_trainer_tpu_torch.parallel.sharding import plan_grad_buckets

# The JAX side is imported lazily: the card's machine has no jax, and the
# cuda test of this file runs there (pytest --noconftest).
jax = importlib.import_module("jax") if importlib.util.find_spec(
    "jax") else None

N = 2
THREADS, SUM_LANES = 256, 32  # the kernels' block and pass-2 warp widths
SCAL = dict(bc1=np.float32(0.271), bc2=np.float32(0.002997),
            step_size=np.float32(-3e-4), lr_scale=np.float32(0.5))


def _leaf_shapes():
    """GPT-2 tiny's leaves as one replica gets them at n = 2, and the
    plan's sharded flags."""
    model = mt.init_gpt2("gpt2_tiny", seed=0, device="cpu", vocab_size=1021)
    params = dict(model.named_parameters())
    plan = plan_grad_buckets(params, N)
    shapes = [(p.shape[0] // N,) + tuple(p.shape[1:]) if sh else
              tuple(p.shape) for p, sh in zip(params.values(), plan.sharded)]
    return shapes, list(plan.sharded)


SHAPES, SHARDED = _leaf_shapes()


def _lists(seed, shapes=SHAPES):
    """(g, p, mu, nu) lists of float32 numpy arrays, made from ``seed``."""
    rng = np.random.default_rng(seed)
    g = [(rng.normal(size=s) * 1e-2).astype(np.float32) for s in shapes]
    p = [(rng.normal(size=s) * 0.02).astype(np.float32) for s in shapes]
    mu = [(rng.normal(size=s) * 1e-3).astype(np.float32) for s in shapes]
    nu = [(np.abs(rng.normal(size=s)) * 1e-5).astype(np.float32)
          for s in shapes]
    return g, p, mu, nu


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _bits(t) -> bytes:
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


# ------------------------------------------------ K4's sum order in numpy
def _tree32(v):
    """A warp's shuffle tree (``warp_sum``) over the last axis of 32."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _by_thread(values, threads, acc=None):
    """Each thread's float32 running sum of ``values`` laid out as the
    kernel lays them out: value j to thread j % threads, in order, added
    to ``acc`` (zeros by default)."""
    steps = -(-values.shape[0] // threads)
    lay = np.zeros(steps * threads, np.float32)
    lay[:values.shape[0]] = values
    acc = np.zeros(threads, np.float32) if acc is None else acc
    for row in lay.reshape(steps, threads):
        acc = acc + row
    return acc


def chunk_partial(q, vec):
    """Pass 1 on one chunk's quotients ``q``: by thread (the float4 part
    element-major within a thread's float4, then the scalar tail), the
    warps' trees, the 8 warps in order."""
    sq = q * q
    acc = np.zeros(THREADS, np.float32)
    done = 0
    if vec:
        n4 = q.shape[0] // 4
        steps = -(-n4 // THREADS)
        lay = np.zeros((steps * THREADS, 4), np.float32)
        lay[:n4] = sq[:4 * n4].reshape(n4, 4)
        for row in lay.reshape(steps, THREADS, 4):
            for k in range(4):
                acc = acc + row[:, k]
        done = 4 * n4
    acc = _by_thread(sq[done:], THREADS, acc)
    warps = _tree32(acc.reshape(THREADS // 32, 32))
    s = np.float32(0.0)
    for w in warps:
        s = np.float32(s + w)
    return s


def leaf_sum(partials):
    """Pass 2 on one leaf's chunk partials: by lane in chunk order, then
    the warp's tree."""
    return _tree32(_by_thread(np.asarray(partials, np.float32), SUM_LANES))


def emulate_sqsum(qs, sharded, vec=None, chunk=fa.CHUNK):
    """K4's sums of the quotient arrays ``qs`` in the kernel's order:
    (per-leaf sums, sq_loc, sq_rep)."""
    vec = [True] * len(qs) if vec is None else vec
    sums = []
    for q, v in zip(qs, vec):
        flat = np.ascontiguousarray(q, np.float32).reshape(-1)
        parts = [chunk_partial(flat[lo:lo + chunk], v)
                 for lo in range(0, flat.shape[0], chunk)]
        sums.append(leaf_sum(parts))
    loc = rep = np.float32(0.0)
    for s, sh in zip(sums, sharded):
        if sh:
            loc = np.float32(loc + s)
        else:
            rep = np.float32(rep + s)
    return sums, loc, rep


# ------------------------------------------------- the emulated library
def _view(ptr, n, ctype):
    if n == 0:
        return np.zeros(0, np.dtype(ctype))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class EmulatedLib:
    """``csrc/fused_adam.cu``'s C entry points over raw host pointers:
    K4 in the kernel's order of operations, K5 by its plain version.
    ``vec`` records each K4 leaf's path (16-byte aligned or scalar)."""

    def __init__(self):
        self.vec = []

    def unscale_sqsum_list_f32(self, g, out, n, chunk0, sharded, n_leaves,
                               chunk, denom_ptr, denom, partials, leaf_sq,
                               sq, compute_sq, accumulate, stream):
        g_p = _view(g, n_leaves, ctypes.c_uint64)
        o_p = _view(out, n_leaves, ctypes.c_uint64)
        sizes = _view(n, n_leaves, ctypes.c_int64)
        c0 = _view(chunk0, n_leaves + 1, ctypes.c_int32)
        flags = _view(sharded, n_leaves, ctypes.c_uint8)
        d = np.float32(denom if denom_ptr is None
                       else _view(denom_ptr, 1, ctypes.c_float)[0])
        part = (_view(partials, int(c0[-1]), ctypes.c_float)
                if compute_sq else None)
        for l in range(n_leaves):
            size = int(sizes[l])
            src = _view(int(g_p[l]), size, ctypes.c_float)
            dst = _view(int(o_p[l]), size, ctypes.c_float)
            vec = int(g_p[l]) % 16 == 0 and int(o_p[l]) % 16 == 0
            self.vec.append(vec)
            for c in range(int(c0[l]), int(c0[l + 1])):
                lo = (c - int(c0[l])) * chunk
                q = src[lo:lo + chunk] / d
                dst[lo:lo + chunk] = q
                if compute_sq:
                    part[c] = chunk_partial(q, vec)
        if compute_sq:
            sums = _view(leaf_sq, n_leaves, ctypes.c_float)
            acc = _view(sq, 2, ctypes.c_float)
            loc, rep = (acc[0], acc[1]) if accumulate else (0.0, 0.0)
            loc, rep = np.float32(loc), np.float32(rep)
            for l in range(n_leaves):
                sums[l] = leaf_sum(part[int(c0[l]):int(c0[l + 1])])
                if flags[l]:
                    loc = np.float32(loc + sums[l])
                else:
                    rep = np.float32(rep + sums[l])
            acc[0], acc[1] = loc, rep
        return 0

    def fused_adam_list_f32(self, ptrs, n, chunk0, n_leaves, chunk,
                            scalars, has_factor, stream):
        p = _view(ptrs, 8 * n_leaves, ctypes.c_uint64).reshape(8, n_leaves)
        sizes = _view(n, n_leaves, ctypes.c_int64)
        bc1, bc2, step, lr, factor = (
            torch.tensor(v) for v in _view(scalars, 5, ctypes.c_float))
        for l in range(n_leaves):
            size = int(sizes[l])
            ins = [torch.from_numpy(_view(int(p[k, l]), size, ctypes.c_float))
                   for k in range(4)]
            outs = fa.fused_adam_update_reference(
                *ins, bc1, bc2, step, lr, factor if has_factor else None)
            for k, o in enumerate(outs):
                _view(int(p[4 + k, l]), size, ctypes.c_float)[:] = o.numpy()
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The kernel wrappers with :class:`EmulatedLib` as the built library
    and small tables, so that GPT-2 tiny's 28 leaves go out in groups."""
    lib = EmulatedLib()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream)
    monkeypatch.setattr(fa, "K4_MAX_LEAVES", 5)
    monkeypatch.setattr(fa, "K5_MAX_LEAVES", 3)
    mt.reset_launch_counts()
    return lib


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("replica", range(N))
@pytest.mark.parametrize("clip", [True, False])
def test_list_plain_versions_are_the_unfused_chain(replica, clip):
    g, p, mu, nu = (_t(a) for a in _lists(10 + replica))
    denom = float(N * 2)
    outs, sums, (loc, rep) = fa.unscale_sqsum_list(
        g, denom, sharded=SHARDED, compute_sq=clip)
    # The trainer's unfused chain (dp_update="sharded", fused_adam=False).
    denom_t = torch.full((), denom, dtype=torch.float32)
    want_loc = torch.zeros((), dtype=torch.float32)
    want_rep = torch.zeros((), dtype=torch.float32)
    want = []
    for gi, sh in zip(g, SHARDED):
        g_u = torch.div(gi, denom_t)
        want.append(g_u)
        s = torch.sum(torch.square(g_u.to(torch.float32)))
        if sh:
            want_loc = want_loc + s
        else:
            want_rep = want_rep + s
    for a, b in zip(outs, want):
        assert _bits(a) == _bits(b)
    if clip:
        assert len(sums) == len(g)
        assert _bits(loc) == _bits(want_loc) and _bits(rep) == _bits(want_rep)
        factor = torch.div(torch.tensor(1.0), torch.maximum(
            torch.sqrt(loc + rep), torch.tensor(1.0)))
    else:
        assert sums is None and loc is None and rep is None
        factor = None

    def sched(count):
        return torch.full((), 3e-4, dtype=torch.float32)

    tx = topt.chain(topt.identity(), topt.get_optimizer("adam", sched))
    names = [str(i) for i in range(len(g))]
    params = dict(zip(names, p))
    state = tx.init(params)
    _e, (adam, sch) = state
    adam["mu"] = dict(zip(names, mu))
    adam["nu"] = dict(zip(names, nu))
    adam["count"] = torch.tensor(4, dtype=torch.int32)
    sch["count"] = torch.tensor(4, dtype=torch.int32)
    gs = outs if factor is None else [t * factor for t in outs]
    updates, (_e, (new_adam, _s)) = tx.update(dict(zip(names, gs)), state,
                                              params)
    _, bc1, bc2, step, _ = fa.adam_scalars(adam["count"], sch["count"], sched)
    got = fa.fused_adam_update_list(outs, p, mu, nu, bc1=bc1, bc2=bc2,
                                    step_size=step, lr_scale=0.5,
                                    factor=factor)
    for i, k in enumerate(names):
        assert _bits(got[0][i]) == _bits(params[k] + updates[k] * 0.5)
        assert _bits(got[1][i]) == _bits(new_adam["mu"][k])
        assert _bits(got[2][i]) == _bits(new_adam["nu"][k])


@pytest.mark.parametrize("replica", range(N))
def test_list_matches_jax_interpret(replica):
    jnp = importlib.import_module("jax.numpy")
    jfa = importlib.import_module("ml_trainer_tpu.ops.kernels.fused_adam")
    g, p, mu, nu = _lists(20 + replica)
    denom = 4.0
    k4 = jax.jit(lambda x: jfa.unscale_sqsum(
        x, denom, compute_sq=True, implementation="pallas", interpret=True))
    j_scal = {k: jnp.asarray(v) for k, v in SCAL.items()}
    k5 = jax.jit(lambda *a: jfa.fused_adam_update(
        *a, **j_scal, factor=jnp.float32(0.37), implementation="pallas",
        interpret=True))
    outs, _, (loc, rep) = fa.unscale_sqsum_list(_t(g), denom,
                                                sharded=SHARDED)
    want_loc = want_rep = jnp.float32(0.0)
    for gi, sh, got in zip(g, SHARDED, outs):
        q, s = k4(jnp.asarray(gi))
        assert _bits(got) == _bits(q)
        if sh:
            want_loc = want_loc + s
        else:
            want_rep = want_rep + s
    np.testing.assert_allclose(loc.item(), float(want_loc), rtol=1e-6)
    np.testing.assert_allclose(rep.item(), float(want_rep), rtol=1e-6)
    got = fa.fused_adam_update_list(
        _t(g), _t(p), _t(mu), _t(nu),
        **{k: torch.tensor(v) for k, v in SCAL.items()},
        factor=torch.tensor(np.float32(0.37)))
    for i, leaf in enumerate(zip(g, p, mu, nu)):
        want = k5(*map(jnp.asarray, leaf))
        for kind, name in enumerate(("p", "mu", "nu", "u")):
            assert got[kind][i].shape == SHAPES[i]
            _close(got[kind][i], want[kind], f"leaf {i} {name}")


SIZE_LISTS = [
    [fa.CHUNK],                      # one leaf, exactly one chunk
    [1],                             # one element
    [0, 5, 0],                       # empty leaves around a small one
    [fa.CHUNK + 1, 384, 0, 3 * fa.CHUNK - 7, 7],
    [int(np.prod(s)) for s in SHAPES],  # GPT-2 tiny's replica list
]


@pytest.mark.parametrize("sizes", SIZE_LISTS)
@pytest.mark.parametrize("chunk", [fa.CHUNK, 4, 12])
def test_chunk_table_covers_every_element_once_in_leaf_order(sizes, chunk):
    chunk0 = fa.chunk_table(sizes, chunk)
    assert chunk0.shape == (len(sizes) + 1,) and chunk0[0] == 0
    covered = []  # (leaf, first, last + 1) of each chunk, in block order
    for c in range(int(chunk0[-1])):
        leaf = int(np.searchsorted(chunk0, c, side="right") - 1)
        lo = (c - int(chunk0[leaf])) * chunk
        covered.append((leaf, lo, min(lo + chunk, sizes[leaf])))
    want = [(leaf, lo, min(lo + chunk, n)) for leaf, n in enumerate(sizes)
            for lo in range(0, n, chunk)]
    assert covered == want
    for max_leaves in (1, 2, 512):
        groups = fa.launch_groups(len(sizes), max_leaves)
        assert [i for lo, hi in groups for i in range(lo, hi)] == list(
            range(len(sizes)))
        assert all(0 < hi - lo <= max_leaves for lo, hi in groups)


def test_flat_views_are_aligned_views_of_one_buffer_per_kind():
    shapes = [(3,), (0,), (5, 2), (), (4, 4)]
    kinds = fa.flat_views(shapes, 3, "cpu")
    assert len(kinds) == 3
    for views in kinds:
        base = views[0].untyped_storage().data_ptr()
        assert [tuple(v.shape) for v in views] == [tuple(s) for s in shapes]
        for v in views:
            assert v.untyped_storage().data_ptr() == base
            assert v.storage_offset() % 4 == 0 and v.is_contiguous()
        spans = [(v.storage_offset(), v.storage_offset() + v.numel())
                 for v in views if v.numel()]
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_sum_order_emulation_matches_the_plain_sums(vec, seed):
    g, _, _, _ = _lists(30 + seed, SHAPES + [(3 * fa.CHUNK + 5,)])
    qs = [(a / np.float32(4.0)).astype(np.float32) for a in g]
    sharded = SHARDED + [True]
    sums, loc, rep = emulate_sqsum(qs, sharded, [vec] * len(qs))
    outs, want, (w_loc, w_rep) = fa.unscale_sqsum_list(
        _t(g), 4.0, sharded=sharded)
    for q, out in zip(qs, outs):
        assert _bits(q) == _bits(out)
    np.testing.assert_allclose(sums, [w.item() for w in want], rtol=1e-6)
    np.testing.assert_allclose([loc, rep], [w_loc.item(), w_rep.item()],
                               rtol=1e-6)


@pytest.mark.parametrize("compute_sq", [True, False])
@pytest.mark.parametrize("denom", [4.0, "device"])
def test_k4_wrapper_through_the_emulated_library(emulated, compute_sq,
                                                 denom):
    g, _, _, _ = _lists(40)
    d = torch.tensor(6.0) if denom == "device" else denom
    outs, sums, (loc, rep) = fa._unscale_list_kernel(_t(g), d, SHARDED,
                                                     compute_sq)
    want = fa.unscale_sqsum_list(_t(g), d, sharded=SHARDED,
                                 compute_sq=compute_sq)
    assert mt.launch_counts()["unscale_sqsum"] == -(-len(g) // 5)
    assert emulated.vec == [True] * len(g)
    for a, b in zip(outs, want[0]):
        assert a.shape == b.shape and _bits(a) == _bits(b)
    if not compute_sq:
        assert sums is None and loc is None and rep is None
        return
    e_sums, e_loc, e_rep = emulate_sqsum([o.numpy() for o in want[0]],
                                         SHARDED)
    assert _bits(torch.stack(sums)) == _bits(np.array(e_sums, np.float32))
    assert _bits(loc) == _bits(e_loc) and _bits(rep) == _bits(e_rep)
    np.testing.assert_allclose([loc.item(), rep.item()],
                               [want[2][0].item(), want[2][1].item()],
                               rtol=1e-6)


@pytest.mark.parametrize("factor", [None, 0.37])
def test_k5_wrapper_through_the_emulated_library(emulated, factor):
    g, p, mu, nu = (_t(a) for a in _lists(50))
    kw = dict(bc1=torch.tensor(SCAL["bc1"]), bc2=torch.tensor(SCAL["bc2"]),
              step_size=torch.tensor(SCAL["step_size"]), lr_scale=0.5,
              factor=None if factor is None else torch.tensor(factor))
    got = fa._adam_list_kernel(g, p, mu, nu, **kw)
    want = fa.fused_adam_update_list(g, p, mu, nu, **kw)
    assert mt.launch_counts()["fused_adam"] == -(-len(g) // 3)
    for kind in range(4):
        base = got[kind][0].untyped_storage().data_ptr()
        for a, b in zip(got[kind], want[kind]):
            assert a.untyped_storage().data_ptr() == base  # one buffer
            assert a.shape == b.shape and _bits(a) == _bits(b)


EDGES = {
    "empty_leaf": [(7,), (0,), (2, 3)],
    "one_leaf": [(3 * fa.CHUNK + 1,)],
    "all_empty": [(0,), (0, 4)],
}


@pytest.mark.parametrize("case", sorted(EDGES) + ["unaligned_view"])
def test_edge_cases(emulated, case):
    if case == "unaligned_view":
        # A view one element into its storage: not 16-byte aligned.
        base = torch.tensor(_lists(60, [(2 * fa.CHUNK + 3,)])[0][0])
        leaves = [torch.tensor(_lists(61, [(9,)])[0][0]), base[1:]]
    else:
        leaves = _t(_lists(60, EDGES[case])[0])
    sharded = [i % 2 == 0 for i in range(len(leaves))]
    plain = fa.unscale_sqsum_list(leaves, 2.0, sharded=sharded)
    got = fa._unscale_list_kernel(leaves, 2.0, sharded, True)
    launched = any(t.numel() for t in leaves)
    assert mt.launch_counts()["unscale_sqsum"] == int(launched)
    for a, b in zip(got[0], plain[0]):
        assert a.shape == b.shape and _bits(a) == _bits(b)
    e_sums, e_loc, e_rep = emulate_sqsum(
        [o.numpy() for o in plain[0]], sharded,
        emulated.vec or [True] * len(leaves))
    assert [s.item() for s in got[1]] == [float(s) for s in e_sums]
    assert (got[2][0].item(), got[2][1].item()) == (e_loc, e_rep)
    for s, w in zip(got[1], plain[1]):
        np.testing.assert_allclose(s.item(), w.item(), rtol=1e-6)
    if case == "unaligned_view":
        assert emulated.vec == [True, False]  # decided per leaf
    ps = [torch.full_like(t, 0.5) for t in leaves]
    k5 = fa._adam_list_kernel(leaves, ps, ps, ps, bc1=0.5, bc2=0.25,
                              step_size=-1e-3, lr_scale=1.0, factor=None)
    want = fa.fused_adam_update_list(leaves, ps, ps, ps, bc1=0.5, bc2=0.25,
                                     step_size=-1e-3, lr_scale=1.0)
    assert mt.launch_counts()["fused_adam"] == int(launched)
    for kind in range(4):
        for a, b in zip(k5[kind], want[kind]):
            assert a.shape == b.shape and _bits(a) == _bits(b)


def test_list_refusals():
    g = torch.ones(4)
    with pytest.raises(ValueError, match="empty"):
        fa.unscale_sqsum_list([], 2.0, sharded=[])
    with pytest.raises(ValueError, match="empty"):
        fa.fused_adam_update_list([], [], [], [], bc1=1.0, bc2=1.0,
                                  step_size=-1.0, lr_scale=1.0)
    with pytest.raises(ValueError, match="Unknown unscale_sqsum"):
        fa.unscale_sqsum_list([g], 2.0, sharded=[True],
                              implementation="pallas")
    with pytest.raises(TypeError, match="float32"):
        fa._unscale_list_kernel([g.double()], 2.0, [True], True)
    with pytest.raises(ValueError, match="sharded flags"):
        fa._unscale_list_kernel([g, g], 2.0, [True], True)
    with pytest.raises(ValueError, match="list lengths differ"):
        fa._adam_list_kernel([g, g], [g], [g, g], [g, g], bc1=1.0, bc2=1.0,
                             step_size=-1.0, lr_scale=1.0, factor=None)
    with pytest.raises(ValueError, match="shapes differ"):
        fa._adam_list_kernel([g], [g[:3]], [g], [g], bc1=1.0, bc2=1.0,
                             step_size=-1.0, lr_scale=1.0, factor=None)


@pytest.mark.cuda
def test_list_kernels_match_the_emulated_order_on_card():
    """The list kernels on the card over GPT-2 tiny's replica list: the
    quotients and K5 bitwise their plain versions, K4's per-leaf sums and
    ``sq_loc``/``sq_rep`` bitwise the numpy emulation of the kernel's
    order, and one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    dev = torch.device("cuda")
    g, p, mu, nu = ([t.to(dev) for t in _t(a)] for a in _lists(70))
    mt.reset_launch_counts()
    outs, sums, (loc, rep) = fa.unscale_sqsum_list(g, 4.0, sharded=SHARDED)
    plain = fa.unscale_sqsum_list(g, 4.0, sharded=SHARDED,
                                  implementation="reference")
    for a, b in zip(outs, plain[0]):
        assert torch.equal(a, b)
    e_sums, e_loc, e_rep = emulate_sqsum([o.cpu().numpy() for o in outs],
                                         SHARDED)
    assert _bits(torch.stack(sums).cpu()) == _bits(
        np.array(e_sums, np.float32))
    assert _bits(loc.cpu()) == _bits(e_loc) and _bits(rep.cpu()) == _bits(
        e_rep)
    kw = dict(bc1=torch.tensor(0.19, device=dev),
              bc2=torch.tensor(0.002, device=dev),
              step_size=torch.tensor(-3e-4, device=dev), lr_scale=0.5,
              factor=torch.tensor(0.3, device=dev))
    got = fa.fused_adam_update_list(outs, p, mu, nu, **kw)
    want = fa.fused_adam_update_list(outs, p, mu, nu,
                                     implementation="reference", **kw)
    for kind in range(4):
        for a, b in zip(got[kind], want[kind]):
            assert torch.equal(a, b)
    assert mt.launch_counts()["unscale_sqsum"] == 1
    assert mt.launch_counts()["fused_adam"] == 1


@pytest.mark.parametrize("guard", [True, False])
def test_sharded_trainer_through_the_emulated_kernels(emulated, monkeypatch,
                                                      tmp_path, guard):
    """The trainer's sharded step with its tail through the kernel
    wrappers (the emulated library on CPU tensors) against the unfused
    tail: one K4 and one K5 launch per replica and table group a step,
    losses within rtol 1e-6 and params within 1e-6 (chip_smoke.py's
    DP_KERNEL_ATOL: the clip factor's rounding, K4's sums being taken in
    the kernel's order), and, without the guard, no optimizer state leaf
    left a view of a larger buffer."""
    monkeypatch.setattr(fa, "_dispatch",
                        lambda name, impl, dev: impl == "auto")
    sets = (mt.SyntheticTokens(size=16, seq_len=32, vocab_size=1021),
            mt.SyntheticTokens(size=8, seq_len=32, vocab_size=1021, seed=1))
    init = mt.init_gpt2("gpt2_tiny", seed=0, device="cpu",
                        vocab_size=1021).state_dict()
    runs = {}
    for fused in (True, False):
        model = mt.get_model("gpt2_tiny", vocab_size=1021, device="cpu")
        model.load_state_dict(init)
        mt.reset_launch_counts()
        tr = mt.Trainer(model, datasets=sets, epochs=1, batch_size=8,
                        optimizer="adam", lr=1e-3, grad_clip_norm=1.0,
                        is_parallel=True, device=["cpu"] * N,
                        dp_update="sharded", fused_adam=fused,
                        nonfinite_guard=guard,
                        model_dir=str(tmp_path / str(fused)))
        tr.fit()
        runs[fused] = (tr, mt.launch_counts())
    (on, counts), (off, _) = runs[True], runs[False]
    steps = on.state.step
    assert steps == 2 and on.fused_adam and not off.fused_adam
    assert counts["unscale_sqsum"] == N * steps * -(-len(SHAPES) // 5)
    assert counts["fused_adam"] == N * steps * -(-len(SHAPES) // 3)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(on.history[key], off.history[key],
                                   rtol=1e-6)
    emb = 128  # gpt2_tiny's width
    for name, p in on.model.state_dict().items():
        want = off.model.state_dict()[name]
        if name.endswith("attn.qkv.bias"):
            # The key bias's gradient is ~0 (softmax ignores a shift of
            # the scores): Adam's normalized step there is ~lr either
            # way, so it is held to lr (as in test_torch_parallel.py).
            torch.testing.assert_close(p[emb:2 * emb], want[emb:2 * emb],
                                       rtol=0, atol=1e-3, msg=name)
            p, want = p[torch.arange(3 * emb) // emb != 1], want[
                torch.arange(3 * emb) // emb != 1]
        torch.testing.assert_close(p, want, rtol=0, atol=1e-6, msg=name)
    leaves = []
    topt.tree_map(leaves.append, on.state.opt_state)
    for t in leaves:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
