"""Neighbour access of the unstructured path: the hand-written CUDA kernels
(``csrc/banded.cu``), their wrappers, and the plain PyTorch version of each.

Counterparts of ``cfd2_tpu/ops/banded_gather.py``:

* :func:`banded_gather` <- ``banded_gather_nk`` / ``banded_gather2_nk``:
  ``out[i, k, ...] = x[idx[i, k], ...]``;
* :func:`banded_prolong_add`: the same gather as the aggregation V-cycle
  uses it for its prolongation (K = 1), fused with the update
  ``base + alpha * x[idx[:, 0]]`` that follows it there;
* :func:`banded_dot` <- ``banded_dot``: ``out_j[i] = sum over (oi, ci) in
  prods[j] of sum_k offs[oi][i, k] * xs[ci][idx[i, k]]`` without the (M, K)
  gathered values ever reaching device memory;
* :func:`banded_jacobi_sweeps` <- ``banded_jacobi_sweeps``: ``sweeps`` Jacobi
  iterations ``z = dinv * (r - A_off z)`` from the seed ``dinv * r`` for
  several right-hand sides that share the operator.

All three take the (M, K) int32 index map itself (square: the mesh's
``ck_neighbor`` or a coarse level's ``ell_neighbor``; rectangular: the
restriction member lists, or the (n_fine, 1) aggregate map for prolongation).
The JAX package's lane/sel/base planes, window walks and pre-blocked
coefficient layout are the TPU's way to gather along lanes and have no
counterpart here.

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU, and
launches its kernel for CUDA tensors; anything else raises.  There is no
fallback from a CUDA tensor to the plain version.  ``LAUNCHES`` counts the
kernel calls per kernel; :func:`reset_launches` zeroes it.  One call of
:func:`banded_jacobi_sweeps` is one cooperative launch that runs every sweep
(:func:`sweeps_plan` picks its form and grid; see the source note in
``csrc/banded.cu``), and :func:`banded_prolong_add` counts under
``banded_gather``, whose work it does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._launch import float_ok, launch

# Kernel calls per wrapper since the last reset_launches().
LAUNCHES = {"banded_gather": 0, "banded_dot": 0, "banded_jacobi_sweeps": 0}

# Limits of csrc/banded.cu.
MAX_X, MAX_OFF, MAX_OUT, MAX_PAIRS, MAX_RHS = 3, 6, 3, 8, 4

# The product lists the solver passes to banded_dot: each has a kernel
# instantiation and a C entry point ``banded_dot_<name>`` of its own
# (csrc/banded.cu).  name -> (operands, planes, prods).  Any other list
# takes the generic instantiation.
DOT_FORMS = {
    "scalar": (1, 1, (((0, 0),),)),
    "mom2": (2, 1, (((0, 0),), ((0, 1),))),
    "schur_rhs": (2, 2, (((0, 0), (1, 1)),)),
    "grad": (1, 2, (((0, 0),), ((1, 0),))),
    "spmv": (3, 6, (((0, 0), (1, 2)), ((0, 1), (2, 2)),
                    ((3, 0), (4, 1), (5, 2)))),
}
_FORM_OF = {(prods, n_x, n_off): name
            for name, (n_x, n_off, prods) in DOT_FORMS.items()}
# (prods, n_x, n_off) -> what a call needs that depends only on them.
_PLANS: dict = {}

# The sweeps kernel's blocks (csrc/banded.cu SW_THREADS), the rows per thread
# its resident form holds in registers (one instantiation each), and the
# most shared memory a block of this card family can opt in to.
SWEEPS_THREADS = 1024
SWEEPS_ROWS_PER_THREAD = (1, 2, 4, 8)
SMEM_PER_BLOCK_MAX = 232_448
# (device index, C) -> the card's limits (banded_sweeps_limits);
# (device index, n, K, C, k_cap) -> SweepsPlan.
_SWEEPS_LIMITS: dict = {}
_SWEEPS_PLANS: dict = {}


class SweepsPlan(NamedTuple):
    """One launch of the sweeps kernel: ``form`` "resident" (each block
    keeps its rows' coefficients in shared memory and its rows' dinv and r
    in registers, ``rows_per_thread`` of them) or "streamed" (each sweep
    reads them again); ``blocks`` of ``rows_per_block`` contiguous rows;
    ``smem_bytes`` of dynamic shared memory per block."""
    form: str
    blocks: int
    rows_per_block: int
    smem_bytes: int
    rows_per_thread: int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Plain versions.


def banded_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`banded_gather`."""
    return x[idx.long()]


def banded_prolong_add_ref(base, x, idx, alpha: float):
    """Plain version of :func:`banded_prolong_add`: the eager gather,
    product and sum of the aggregation V-cycle's prolongation."""
    return base + alpha * x[idx[:, 0].long()]


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as the card's fused multiply-add rounds
    it: float32 operands are taken through float64, where the product is
    exact.  Rounding the float64 sum to float32 rounds the exact sum except
    where the float64 sum lies on a float32 midpoint (the 29 bits under a
    float32 mantissa: 1, then 0s) or under float32's normal range; there it
    is rounded to odd first (TwoSum's error picks the odd neighbour), whose
    float32 rounding is the correctly rounded one.  Other dtypes are
    computed as they are."""
    if a.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bits = s.view(torch.int64).reshape(-1)
    near = ((bits & 0x1FFFFFFF == 0x10000000)
            | (s.reshape(-1).abs() < 2.0 ** -126)).nonzero()[:, 0]
    if near.numel():
        pn, cn = p.reshape(-1)[near], c.reshape(-1)[near]
        sn, bn = s.reshape(-1)[near], bits[near]
        z = sn - pn
        err = (pn - (sn - z)) + (cn - z)
        step = torch.where((err > 0) == (sn > 0), 1, -1)
        bits[near] = torch.where((err != 0) & (bn & 1 == 0), bn + step, bn)
    return s.float()


def banded_dot_ref(xs, offs, idx, prods):
    """Plain version of :func:`banded_dot`, in the kernel's arithmetic: per
    output and slot the first product rounded, each further one added by a
    fused multiply-add (nvcc contracts the kernel's ``s += o * x``), then
    the slots added in ascending order."""
    idx = idx.long()
    gs = [x[idx] for x in xs]
    out = []
    for pairs in prods:
        acc = None
        for (oi, ci) in pairs:
            acc = (offs[oi] * gs[ci] if acc is None
                   else fma(offs[oi], gs[ci], acc))
        out.append(_slot_sum(acc))
    return tuple(out)


def _slot_sum(t: torch.Tensor) -> torch.Tensor:
    """The rows of an (M, K) tensor summed from zero in ascending slot
    order, as the kernels add them (torch's ``sum`` takes another order for
    K > 3); K may be 0 (a slot cap of 0)."""
    tot = t.new_zeros(t.shape[:1])
    for k in range(t.shape[1]):
        tot = tot + t[:, k]
    return tot


def banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps: int, k_cap=None):
    """Plain version of :func:`banded_jacobi_sweeps`: the loop of
    ``ellsys._momentum_solve`` over the first ``k_cap`` slots, each sweep's
    products added in ascending slot order as the kernel adds them."""
    if k_cap is not None:
        off, idx = off[:, :k_cap], idx[:, :k_cap]
    idx = idx.long()
    zs = [dinv * r for r in rs]
    for _ in range(sweeps - 1):
        zs = [dinv * (r - _slot_sum(off * z[idx])) for r, z in zip(rs, zs)]
    return tuple(zs)


# ----------------------------------------------------------------------
# Wrappers.


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_idx(idx, device):
    if idx.dim() != 2:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected (M, K)")
    _check("idx", idx, None, device, torch.int32)


def _raise_on(lib, err: int, fn: str) -> None:
    if err != 0:
        msg = lib.banded_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def _cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no banded-gather implementation for device {t.device}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def banded_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour values per slot: ``x`` (n_src,) or (n_src, C) float32,
    ``idx`` (M, K) int32 with values in [0, n_src) -> (M, K) or (M, K, C).
    The C components of one neighbour share the index load; for even C the
    kernel moves them 8 bytes at a time, so ``x`` must be 8-byte aligned (a
    view that starts at an odd float is refused)."""
    if not _cuda_or_cpu(x):
        return banded_gather_ref(x, idx)
    dev = x.device
    if x.dim() not in (1, 2):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (n_src,) "
                         "or (n_src, C)")
    _check("x", x, None, dev)
    _check_idx(idx, dev)
    M, K = idx.shape
    C = 1 if x.dim() == 1 else x.shape[1]
    if C % 2 == 0 and x.data_ptr() % 8:
        raise ValueError(f"x (C = {C}) must be 8-byte aligned: the kernel "
                         "reads its rows as float2")
    out = torch.empty((M, K) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=dev)
    lib = _build.load("banded")
    err = launch(lib.banded_gather, dev, x.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), M, K, C)
    _raise_on(lib, err, "banded_gather")
    LAUNCHES["banded_gather"] += 1
    return out


def banded_prolong_add(base: torch.Tensor, x: torch.Tensor,
                       idx: torch.Tensor, alpha: float) -> torch.Tensor:
    """``base + alpha * x[idx[:, 0]]`` in one launch: the aggregation
    V-cycle's prolongation through the (M, 1) aggregate map added to the
    finer level's iterate.  ``base`` (M,), ``x`` (n_src,) float32, ``idx``
    (M, 1) int32.  The product and the sum are rounded as the eager ops
    round them, so the result equals :func:`banded_prolong_add_ref` bit for
    bit.  Returns a new (M,) tensor."""
    if not _cuda_or_cpu(base):
        return banded_prolong_add_ref(base, x, idx, alpha)
    dev = base.device
    if not (idx.dim() == 2 and idx.dtype is torch.int32 and idx.device == dev
            and idx.is_contiguous()):
        _check_idx(idx, dev)
    M, K = idx.shape
    if K != 1:
        raise ValueError(f"idx has shape {(M, K)}, expected (M, 1)")
    if not (float_ok(base, (M,), dev) and x.dim() == 1
            and float_ok(x, x.shape, dev)):
        _check("base", base, (M,), dev)
        if x.dim() != 1:
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             "(n_src,)")
        _check("x", x, None, dev)
    out = torch.empty_like(base)
    lib = _build.load("banded")
    err = launch(lib.banded_prolong_add, dev, base.data_ptr(), x.data_ptr(),
                 idx.data_ptr(), float(alpha), out.data_ptr(), M)
    _raise_on(lib, err, "banded_prolong_add")
    LAUNCHES["banded_gather"] += 1
    return out


def dot_form(prods, n_x: int, n_off: int) -> str:
    """The name of the kernel instantiation that :func:`banded_dot` picks
    for this product list: one of ``DOT_FORMS``, or "generic"."""
    return _plan(prods, n_x, n_off)[0]


def _plan(prods, n_x: int, n_off: int):
    """What a call takes of a product list: (form name, n_out, and for the
    generic form pair_off, pair_x, pair_start as ctypes arrays), validated
    and marshalled at the list's first use and kept."""
    try:
        return _PLANS[(prods, n_x, n_off)]
    except (KeyError, TypeError):   # first use, or lists where tuples hash
        pass
    prods = tuple(tuple(tuple(pair) for pair in p) for p in prods)
    key = (prods, n_x, n_off)
    if key in _PLANS:
        return _PLANS[key]
    n_pairs = sum(len(p) for p in prods)
    if not (1 <= n_x <= MAX_X and 1 <= n_off <= MAX_OFF
            and 1 <= len(prods) <= MAX_OUT and n_pairs <= MAX_PAIRS):
        raise ValueError(
            f"banded_dot takes at most {MAX_X} operands, {MAX_OFF} planes, "
            f"{MAX_OUT} outputs and {MAX_PAIRS} products; got {n_x}, "
            f"{n_off}, {len(prods)}, {n_pairs}")
    pair_off, pair_x, start = [], [], [0]
    for pairs in prods:
        for (oi, ci) in pairs:
            if not (0 <= oi < n_off and 0 <= ci < n_x):
                raise ValueError(f"product ({oi}, {ci}) names no plane or "
                                 "operand")
            pair_off.append(oi)
            pair_x.append(ci)
        start.append(len(pair_off))
    plan = _PLANS[key] = (_FORM_OF.get(key, "generic"), len(prods),
                          _ints(pair_off), _ints(pair_x), _ints(start))
    return plan


def banded_dot(xs, offs, idx: torch.Tensor, prods):
    """Fused gather-dot: ``out_j[i] = sum over (oi, ci) in prods[j] of
    sum_k offs[oi][i, k] * xs[ci][idx[i, k]]``.

    ``xs``: up to 3 (n_src,) float32 operands; ``offs``: up to 6 (M, K)
    float32 coefficient planes; ``idx``: (M, K) int32; ``prods``: per output
    (up to 3) a tuple of (plane, operand) pairs.  Returns a tuple of (M,)
    tensors (rows of one (n_out, M) tensor on the card)."""
    xs, offs = tuple(xs), tuple(offs)
    if not _cuda_or_cpu(xs[0]):
        return banded_dot_ref(xs, offs, idx, prods)
    dev = xs[0].device
    if not (idx.dim() == 2 and idx.dtype is torch.int32 and idx.device == dev
            and idx.is_contiguous()):
        _check_idx(idx, dev)
    form, n_out, pair_off, pair_x, start = _plan(prods, len(xs), len(offs))
    src_shape, shape = xs[0].shape, idx.shape
    ok = len(src_shape) == 1
    for x in xs:
        ok = ok and float_ok(x, src_shape, dev)
    for o in offs:
        ok = ok and float_ok(o, shape, dev)
    if not ok:
        for c, x in enumerate(xs):
            _check(f"xs[{c}]", x, src_shape[:1], dev)
        for p, o in enumerate(offs):
            _check(f"offs[{p}]", o, shape, dev)
    M, K = shape
    lib = _build.load("banded")
    # One allocation for all outputs; a single output is returned as it is
    # (unbind costs the host as much as the allocation).
    out = xs[0].new_empty((M,) if n_out == 1 else (n_out, M))
    if form == "generic":
        err = launch(lib.banded_dot, dev, _ptrs(xs), len(xs), _ptrs(offs),
                     len(offs), out.data_ptr(), n_out, pair_off, pair_x,
                     start, idx.data_ptr(), M, K)
    else:
        err = launch(getattr(lib, "banded_dot_" + form), dev,
                     *[x.data_ptr() for x in xs],
                     *[o.data_ptr() for o in offs], out.data_ptr(),
                     idx.data_ptr(), M, K)
    _raise_on(lib, err, "banded_dot")
    LAUNCHES["banded_dot"] += 1
    return (out,) if n_out == 1 else out.unbind(0)


def sweeps_plan(n: int, K: int, C: int, k_cap, n_sm: int,
                smem_per_block: int, streamed_per_sm: int = 1) -> SweepsPlan:
    """The launch of :func:`banded_jacobi_sweeps` for an (n, K) map walked
    over its first ``k_cap`` slots (None: all K) with C right-hand sides, on
    a card of ``n_sm`` SMs whose blocks may use ``smem_per_block`` bytes of
    shared memory and that holds ``streamed_per_sm`` blocks of the streamed
    form per SM.

    Resident where it fits: at most one block per SM, each owning
    ``ceil(n / blocks)`` rows, which must fit the largest register
    instantiation and ``8 * k_cap`` bytes of shared memory per row.  Else
    streamed: every SM's blocks, each owning a contiguous range of rows.
    C does not enter the choice (the registers of r are counted in the
    instantiations); it is an argument so that the plan names its launch."""
    if not 1 <= C <= MAX_RHS:
        raise ValueError(f"C = {C} is outside 1..{MAX_RHS}")
    kc = K if k_cap is None else int(k_cap)
    smem_max = min(int(smem_per_block), SMEM_PER_BLOCK_MAX)
    per_block = lambda blocks: -(-n // blocks)
    blocks = max(1, min(n_sm, -(-n // SWEEPS_THREADS)))
    rows = per_block(blocks)
    smem = 8 * kc * rows
    for rpt in SWEEPS_ROWS_PER_THREAD:
        if rows <= rpt * SWEEPS_THREADS and smem <= smem_max:
            return SweepsPlan("resident", blocks, rows, smem, rpt)
    blocks = max(1, min(n_sm * streamed_per_sm, -(-n // SWEEPS_THREADS)))
    return SweepsPlan("streamed", blocks, per_block(blocks), 0, 0)


def _sweeps_limits(lib, dev: torch.device, C: int):
    """(SM count, shared memory per block, resident and streamed blocks
    per SM) of ``dev`` for C right-hand sides, asked of the library once."""
    key = (dev.index, C)
    lim = _SWEEPS_LIMITS.get(key)
    if lim is None:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            _raise_on(lib, lib.banded_sweeps_limits(C, out),
                      "banded_sweeps_limits")
        lim = _SWEEPS_LIMITS[key] = tuple(out)
        if lim[2] < 1 or lim[3] < 1:
            raise RuntimeError(f"the sweeps kernel does not fit an SM of "
                               f"{torch.cuda.get_device_name(dev)}: {lim}")
    return lim


def device_sweeps_plan(dev: torch.device, n: int, K: int, C: int,
                       k_cap: int) -> SweepsPlan:
    """:func:`sweeps_plan` on the card ``dev``, kept per shape."""
    key = (dev.index, n, K, C, k_cap)
    plan = _SWEEPS_PLANS.get(key)
    if plan is None:
        n_sm, smem, _, streamed = _sweeps_limits(_build.load("banded"), dev,
                                                 C)
        plan = _SWEEPS_PLANS[key] = sweeps_plan(n, K, C, k_cap, n_sm, smem,
                                                streamed)
    return plan


def launch_sweeps(rs, dinv, off, idx, sweeps: int, k_cap: int,
                  plan: SweepsPlan):
    """The launch of :func:`banded_jacobi_sweeps` on CUDA tensors that
    have passed its checks, as ``plan`` lays it out; raises when the card
    refuses it (a grid larger than the card holds at once among them)."""
    dev = rs[0].device
    n, K = idx.shape
    C = len(rs)
    za = torch.empty((C, n), dtype=torch.float32, device=dev)
    zb = torch.empty((C, n), dtype=torch.float32, device=dev) \
        if sweeps > 1 else za
    lib = _build.load("banded")
    _sweeps_limits(lib, dev, C)    # lets the kernels of C opt in to smem
    form = plan.rows_per_thread if plan.form == "resident" else 0
    err = launch(lib.banded_jacobi_sweeps, dev, _ptrs(rs), C, dinv.data_ptr(),
                 off.data_ptr(), idx.data_ptr(), za.data_ptr(), zb.data_ptr(),
                 n, K, k_cap, int(sweeps), form, plan.blocks,
                 plan.rows_per_block, plan.smem_bytes)
    _raise_on(lib, err, "banded_jacobi_sweeps")
    LAUNCHES["banded_jacobi_sweeps"] += 1
    z = za if sweeps % 2 == 1 else zb
    return tuple(z[c] for c in range(C))


def banded_jacobi_sweeps(rs, dinv, off, idx, sweeps: int, k_cap=None):
    """``sweeps`` Jacobi iterations ``z = dinv * (r - A_off z)`` from the
    seed ``z0 = dinv * r`` (so ``sweeps - 1`` applications of ``A_off``) for
    each right-hand side in ``rs``, in one call.

    ``rs``: up to 4 (n,) float32; ``dinv``: (n,); ``off``: (n, K) float32
    off-diagonal coefficients over ``idx`` (n, K) int32.  ``k_cap``: walk
    only the slots ``k < k_cap`` (the slot-capped smoother of the JAX
    package, which drops the rare occupied slots beyond the cap); None walks
    all K.  Returns a tuple of (n,) tensors."""
    rs = tuple(rs)
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if not _cuda_or_cpu(rs[0]):
        return banded_jacobi_sweeps_ref(rs, dinv, off, idx, sweeps, k_cap)
    dev = rs[0].device
    _check_idx(idx, dev)
    n, K = idx.shape
    C = len(rs)
    if not 1 <= C <= MAX_RHS:
        raise ValueError(f"banded_jacobi_sweeps takes 1..{MAX_RHS} "
                         f"right-hand sides, got {C}")
    cap = K if k_cap is None else int(k_cap)
    if not 0 <= cap <= K:
        raise ValueError(f"k_cap {k_cap} is outside [0, {K}]")
    for c, r in enumerate(rs):
        _check(f"rs[{c}]", r, (n,), dev)
    _check("dinv", dinv, (n,), dev)
    _check("off", off, (n, K), dev)
    return launch_sweeps(rs, dinv, off, idx, sweeps, cap,
                         device_sweeps_plan(dev, n, K, C, cap))
