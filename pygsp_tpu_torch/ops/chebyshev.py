"""Chebyshev polynomial filtering, the hot path.

Counterpart of :mod:`pygsp_tpu.ops.chebyshev` on every storage format. The
three-term recurrence runs as a Python loop whose state is ``(T_{k-1} s, T_k s,
accumulators for all Nf filters)``, so the K SpMMs are shared by the whole
filter bank. The whole recurrence runs in the operator's internal vertex order,
as the JAX package's ``_cheby_op_chunked`` does for the chunked and windowed
formats; the operator says how
(:meth:`~pygsp_tpu_torch.core.operators.LaplacianOp.hoisted`,
:meth:`~pygsp_tpu_torch.core.operators.LaplacianOp.shifted_step`).

Each step after the SpMM is one launch of the fused step kernel
(:mod:`pygsp_tpu_torch.core.cheby_kernel`), where the JAX package has the
XLA fusions of its ``lax.scan`` bodies. The step writes into a ring of
``g + 2`` terms, and the accumulators are updated once per ``g`` steps: the
JAX package's accumulator grouping of the chunked and windowed formats,
with its
environment settings ``PYGSP_CHEBY_ACC_GROUP`` and ``PYGSP_CHEBY_DEVICE_MB``,
so that both packages pick the same ``g`` there. The port groups on the
CSR, ELL and banded formats too, where the JAX package adds each term as it
comes:
the bank's accumulators are then read and written once per group instead of
once per step, the same sums in another order. ``PYGSP_CHEBY_GROUP_UNROLL``
is not ported: it only chooses how XLA compiles the group's body.

The bf16 modes of the chunked and windowed formats (``carry_dtype``,
``vals_dtype``)
follow the JAX package: the carried terms are stored narrow, every row sum,
diagonal term and accumulator stays in the signal's dtype, and the mode is
gated by :func:`carry_error_estimate`.

:func:`cheby_op_fixed_graph` is the training path: ``cheby_op`` under a
``torch.autograd.Function`` whose backward runs two fresh recurrences, the
JAX package's constant-memory custom VJP. Through the graph's weights,
:func:`cheby_op` itself differentiates on every format (:class:`_ChebyOp`:
the terms kept, a Clenshaw adjoint on the transpose, the values'
cotangent by the SDDMM a step on a CSR or the CSR view of a slot format's
live slots, by batched tile products on a banded matrix).

Signal convention: ``x`` has shape ``(N, ...)``; ``cheby_op`` returns
``(Nf, N, ...)``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from pygsp_tpu_torch.core import cheby_kernel, csr_kernel
from pygsp_tpu_torch.core.operators import SCALED_OUTPUT, LaplacianOp, matvec
from pygsp_tpu_torch.core.banded_kernel import BAND_TILE
from pygsp_tpu_torch.core.sparse import (BF16_GRAD as _BF16_GRAD,
                                         BandedMatrix, band_operands,
                                         band_tiles, entry_pair, fp32_matmul,
                                         spmm)
from pygsp_tpu_torch.utils import check_device

_FORMAT_ONLY = ('{} is only supported on chunked/windowed operator formats '
                '(the hot path)')
# The JAX package's largest accumulator group (its measured optimum on the
# bench graph; the group rule's cap).
_MAX_GROUP = 14


def cheby_coeff(evaluate, lmax, m: int = 30, grid_n: int | None = None,
                dtype=None, *, device='cuda'):
    """Chebyshev–Gauss quadrature coefficients of a filter bank.

    Parameters
    ----------
    evaluate : callable λ(1-D tensor) -> (Nf, len(λ)) kernel responses.
    lmax : scalar, the spectrum upper bound; quadrature samples [0, lmax].
    m : Chebyshev order.
    grid_n : quadrature grid size, default m + 1.
    dtype, device : of the grid and the result (default float32, CUDA).

    Returns
    -------
    c : (Nf, m + 1) coefficient tensor.

    Examples
    --------
    >>> import torch
    >>> c = cheby_coeff(lambda x: torch.exp(-x)[None, :], lmax=2.0, m=4,
    ...                 device='cpu')
    >>> tuple(c.shape)
    (1, 5)
    """
    device = check_device(device, 'cheby_coeff')
    n = grid_n if grid_n else m + 1
    dtype = torch.get_default_dtype() if dtype is None else dtype
    lmax = torch.as_tensor(lmax, dtype=dtype, device=device)
    a1 = lmax / 2
    a2 = lmax / 2
    j = torch.arange(n, dtype=dtype, device=device) + 0.5
    grid = torch.cos(torch.pi * j / n)                         # (n,)
    kvals = torch.atleast_2d(evaluate(a1 * grid + a2))         # (Nf, n)
    orders = torch.arange(m + 1, dtype=dtype, device=device)
    cosmat = torch.cos(torch.pi * orders[:, None] * j[None, :] / n)
    return (2.0 / n) * kvals @ cosmat.T                        # (Nf, m+1)


# ---------------------------------------------------------------------------
# the bf16 modes: the carry gate and the values' cast
# ---------------------------------------------------------------------------

def carry_error_estimate(c, carry_dtype) -> float:
    """A-priori relative-error bound of the reduced-precision carry mode.

    Each recurrence step rounds the carried term to ``carry_dtype`` (unit
    roundoff u); the three-term recurrence propagates a step-k perturbation
    with factor ≤ (k' − k + 1) into later terms, so the output error is
    bounded by ``u · Σ_k (k + 1)·|c_k|``, normalized by the series' own peak
    magnitude ``max_λ |Σ' c_k T_k|`` (evaluated on a dense Chebyshev grid).
    The JAX package's function, with ``torch.finfo(carry_dtype).eps``.
    """
    c = np.atleast_2d(torch.as_tensor(c).detach().to('cpu', torch.float64)
                      .numpy())
    u = float(torch.finfo(carry_dtype).eps) / 2
    k = np.arange(c.shape[1])
    amp = np.sum((k[None, :] + 1) * np.abs(c), axis=1)        # per filter
    theta = np.linspace(0.0, np.pi, 512)
    T = np.cos(k[:, None] * theta[None, :])                   # (m+1, grid)
    g = c @ T - 0.5 * c[:, :1] * T[:1]                        # 0.5·c0 conv
    gmax = np.abs(g).max(axis=1)
    return float((u * amp / np.maximum(gmax, 1e-300)).max())


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix('torch.')


def _check_carry_budget(c, carry_dtype, carry_tol):
    """Refuse a carry whose :func:`carry_error_estimate` exceeds
    ``carry_tol`` (default 0.05, environment ``PYGSP_CARRY_TOL``), with the
    JAX package's message."""
    if carry_tol is None:
        carry_tol = float(os.environ.get('PYGSP_CARRY_TOL', 0.05))
    est = carry_error_estimate(c, carry_dtype)
    if est > carry_tol:
        raise ValueError(
            f'carry_dtype={_dtype_name(carry_dtype)} refused: the '
            f'a-priori relative error bound {est:.2e} exceeds carry_tol='
            f'{carry_tol:.0e} — this filter bank\'s Chebyshev '
            f'coefficients decay too slowly to absorb the carry '
            f'rounding. Pass carry_tol={est * 1.1:.1e} to override, or '
            f'drop carry_dtype for the exact path.')


def _cast_vals(L: LaplacianOp, vals_dtype) -> LaplacianOp:
    """Opt-in reduced-precision edge values (the chunked and windowed formats):
    the SpMM's products are then formed in ``promote(carry, vals)``, bf16·bf16
    with a bf16 carry. Costs one rounding of each edge weight: exact for unit
    and power-of-two weights. The diagonal stays as it is."""
    if vals_dtype is None:
        return L
    if not isinstance(L.offdiag, SCALED_OUTPUT):
        raise ValueError(_FORMAT_ONLY.format('vals_dtype'))
    return LaplacianOp(offdiag=L.offdiag.astype(vals_dtype), diag=L.diag,
                       lap_type=L.lap_type)


def _promote(L: LaplacianOp, x, promote_x: bool = True):
    """The operator and signal in one arithmetic: the signal promoted with
    the off-diagonal's dtype (unless it is carried narrow), and the operator
    made to fit it. The CSR, ELL and banded kernels take one dtype, so their
    operator is cast; the chunked and windowed SpMMs mix dtypes themselves,
    so only their diagonal is cast to the signal's dtype."""
    pdt = torch.promote_types(x.dtype, L.offdiag.dtype)
    if promote_x:
        x = x.to(pdt)
    if isinstance(L.offdiag, SCALED_OUTPUT):
        if L.diag.dtype != x.dtype:
            L = LaplacianOp(offdiag=L.offdiag, diag=L.diag.to(x.dtype),
                            lap_type=L.lap_type)
    elif L.dtype != pdt:
        L = L.astype(pdt)
    return L, x


def _prepare(L: LaplacianOp, c, x, carry_dtype=None, carry_tol=None,
             vals_dtype=None):
    """The JAX package's checks and dtype rules
    (``pygsp_tpu/ops/chebyshev.py:144-166``): ``(L, c, x, carry_dtype)``.
    A carry in the signal's own dtype is the exact path (``carry_dtype``
    comes back None); a narrower one runs on the chunked and windowed
    formats only, under the carry gate; without one the signal is promoted
    once."""
    c = torch.atleast_2d(torch.as_tensor(c))
    if c.shape[1] < 2:
        raise ValueError('Chebyshev coefficients need order >= 1')
    if carry_dtype is not None and carry_dtype == x.dtype:
        carry_dtype = None
    if carry_dtype is not None:
        if not isinstance(L.offdiag, SCALED_OUTPUT):
            raise ValueError(_FORMAT_ONLY.format('carry_dtype'))
        _check_carry_budget(c, carry_dtype, carry_tol)
    L = _cast_vals(L, vals_dtype)
    L, x = _promote(L, x, promote_x=carry_dtype is None)
    return L, c.to(dtype=x.dtype, device=x.device), x.contiguous(), carry_dtype


# ---------------------------------------------------------------------------
# which calls autograd records
# ---------------------------------------------------------------------------

def _operator_tensors(L: LaplacianOp) -> list:
    """L's diagonal and every tensor of its off-diagonal, those of nested
    levels, slot tables and residue lists included."""
    out = [L.diag]

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        elif isinstance(v, tuple):          # levels, NamedTuples
            for w in v:
                walk(w)

    walk(L.offdiag)
    return out


def _operator_records(L: LaplacianOp, lmax) -> bool:
    """Whether autograd would record the bank through the operator: grad
    mode is on and L's tensors or a tensor λmax require grad."""
    return torch.is_grad_enabled() and (
        getattr(lmax, 'requires_grad', False)
        or any(t.requires_grad for t in _operator_tensors(L)))


def _records(L: LaplacianOp, c, x, lmax) -> bool:
    """Whether autograd would record the bank: grad mode is on and L's
    tensors, ``c``, ``x`` or a tensor λmax require grad."""
    return (torch.is_grad_enabled() and (c.requires_grad or x.requires_grad)
            or _operator_records(L, lmax))


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

def _start(op: LaplacianOp, lmax: float, x, carry_dtype=None):
    """``(t_old, t_cur, step)``: the terms ``T̃_0 x`` and ``T̃_1 x`` on
    [0, lmax], stored in the carry dtype, and the step that makes the
    next (:meth:`LaplacianOp.shifted_step`), for ``op`` in its internal
    order. The first SpMM reads the carried ``x`` and its diagonal term the
    signal itself, as in the JAX package."""
    a1 = a2 = lmax / 2
    t_old = x if carry_dtype is None else x.to(carry_dtype)
    diag = op.diag.reshape((-1,) + (1,) * (x.ndim - 1))
    y0 = spmm(op.offdiag, t_old, out_dtype=t_old.dtype)
    t_cur = ((diag * x + y0) - a2 * x) / a1
    # 2/a1 * (L - a2 I) t - t_old, in the format's own arithmetic
    return t_old, t_cur.to(t_old.dtype), op.shifted_step(2.0 / a1, a2)


def _terms(op: LaplacianOp, lmax: float, x, m1: int, carry_dtype=None):
    """Yields the recurrence terms ``T̃_k x`` for k = 0..m1-1, holding
    only the last two."""
    t_old, t_cur, step = _start(op, lmax, x, carry_dtype)
    yield t_old
    yield t_cur
    for _ in range(2, m1):
        t_old, t_cur = t_cur, step(t_cur, t_old)
        yield t_cur


def acc_group(rem: int, n_values: int, signal_dtype, carry_dtype,
              slab_bytes: int, nf: int) -> int:
    """The JAX package's accumulator group ``g`` (steps whose terms are
    added to the accumulators in one pass) for ``rem`` steps of a signal of
    ``n_values`` values: ``PYGSP_CHEBY_ACC_GROUP`` if set, else the largest
    ``g`` up to 14 whose terms fit the budget ``PYGSP_CHEBY_DEVICE_MB``
    (12288) after the operator's ``slab_bytes`` (:func:`_operator_bytes`),
    the Nf accumulators and four terms."""
    if os.environ.get('PYGSP_CHEBY_ACC_GROUP'):
        return min(int(os.environ['PYGSP_CHEBY_ACC_GROUP']), max(rem, 1))
    term_bytes = max(n_values * carry_dtype.itemsize, 1)
    acc_bytes = max(n_values * signal_dtype.itemsize, 1)
    budget = float(os.environ.get('PYGSP_CHEBY_DEVICE_MB', 12288)) * 2**20
    avail = (budget - slab_bytes - nf * acc_bytes
             - 4 * max(term_bytes, acc_bytes))
    return max(1, min(rem, _MAX_GROUP, int(avail // term_bytes)))


def _operator_bytes(off) -> int:
    """The operator bytes the group rule counts: on the chunked and windowed
    formats the JAX package's own count (their ``stored_bytes``, the JAX
    package's tree leaves); on the CSR, ELL and banded formats, which the
    JAX package does not group, the port's tensors twice over (the step
    keeps a scaled copy)."""
    if isinstance(off, SCALED_OUTPUT):
        return off.stored_bytes()
    return 2 * sum(getattr(off, f.name).nbytes
                   for f in dataclasses.fields(off)
                   if isinstance(getattr(off, f.name), torch.Tensor))


def _grouped_steps(step, m1: int, t_old, t_cur, g: int, group, slab=None,
                   fresh: bool = False):
    """Steps 2..m1-1 of the recurrence: the terms go into a ring of ``g + 2``
    buffers and are handed on ``g`` steps at a time (the first
    ``(m1 - 2) mod g`` one at a time), as the JAX package's grouped
    accumulation does: ``group(ring, k, size, start)`` takes terms
    ``k .. k + size - 1``, which stand in ring slots ``start, start + 1,
    ...`` (wrapping). A group's terms and the two terms before it, which
    its first steps read, are distinct slots. With ``slab`` (m1, N, ...)
    the ring is the slab and term k goes to slot k, where it stays (the
    backward through the operator reads every term). With ``fresh``
    (autograd records the recurrence) each term is a tensor of its own and
    a group gets its terms stacked: the ring's slots are views of one
    tensor, so a write to one would invalidate the terms autograd saved
    from another. The same steps and groups either way, so the same
    bits."""
    if fresh:
        terms = {}
    elif slab is None:
        slots, shift = g + 2, 2
        ring = torch.empty((slots,) + t_cur.shape, dtype=t_cur.dtype,
                           device=t_cur.device)
    else:
        ring, slots, shift = slab, m1, 0
    head = 2 + (m1 - 2) % g
    for k in range(2, m1):                 # term k goes to slot k - shift
        if fresh:
            t_old, t_cur = t_cur, step(t_cur, t_old)
            terms[k] = t_cur
        else:
            t_old, t_cur = t_cur, step(t_cur, t_old,
                                       ring[(k - shift) % slots])
        size = 1 if k < head else g
        if size == 1 or (k - head) % g == g - 1:
            if fresh:
                group(torch.stack([terms.pop(j) for j in
                                   range(k + 1 - size, k + 1)]),
                      k + 1 - size, size, 0)
            else:
                group(ring, k + 1 - size, size,
                      (k + 1 - size - shift) % slots)


def cheby_op(L: LaplacianOp, lmax, c, x: torch.Tensor,
             carry_dtype=None, carry_tol: float | None = None,
             vals_dtype=None) -> torch.Tensor:
    """Apply a Chebyshev-approximated filter bank: ``(Nf, m+1), (N, ...) -> (Nf, N, ...)``.

    Shifted recurrence on [0, lmax] with the 0.5·c0 convention, all Nf
    filters accumulated from the shared recurrence terms, in the
    operator's internal vertex order (:meth:`LaplacianOp.hoisted`).

    ``carry_dtype`` (chunked and windowed formats only): the dtype the
    recurrence terms
    are carried in; ``torch.bfloat16`` halves the bytes of every SpMM's
    operand and of the window tensor, while row sums, diagonal terms and
    accumulators stay in the signal's dtype, so each step rounds once. It
    is gated by :func:`carry_error_estimate` against ``carry_tol`` (default
    0.05, environment ``PYGSP_CARRY_TOL``). ``vals_dtype`` (chunked and
    windowed only) casts the stored edge values. On the CSR, ELL and banded
    formats both raise the JAX package's ``ValueError``.

    Under autograd the bank differentiates with respect to the operator's
    value leaves (:meth:`leaves`: a CSR's ``vals``, and so, through
    :func:`~pygsp_tpu_torch.core.operators.laplacian_op`, W's values; an
    ELL's ``ell_vals`` and levels' ``vals``; a chunked matrix's blocks' and
    tiers' ``vals``; a windowed matrix's slab ``vals`` and tiers' ``vals``;
    a banded matrix's ``tiles``), its diagonal, a tensor ``lmax``, ``c``
    and ``x``, on every format and both devices (:class:`_ChebyOp`: the
    terms kept, m+1 (N, ...) units, and a Clenshaw adjoint). A caller
    replaces a format's leaves with ``with_leaves``, as the JAX caller
    replaces its pytree's. The stored padding slots get a cotangent of 0:
    the kernels never read them. The bank differentiates once. On the CPU
    a gradient through ``x`` alone runs the plain recurrence under
    autograd, which differentiates again (``create_graph=True``). The bf16
    modes are not differentiated: under autograd's route they raise
    ``ValueError``.
    """
    L, c, x, cdt = _prepare(L, c, x, carry_dtype, carry_tol, vals_dtype)
    op, pin, pout = L.hoisted()
    if _records(L, c, x, lmax) and (x.device.type != 'cpu' or c.requires_grad
                                    or _operator_records(L, lmax)):
        if cdt is not None or (vals_dtype is not None
                               and L.offdiag.dtype != x.dtype):
            raise ValueError(_BF16_GRAD.format('cheby_op'))
        vals, *more = L.offdiag.buffers()
        return pout(_ChebyOp.apply(L, vals, op.diag, lmax, c, pin(x), *more),
                    axis=1)
    return pout(_bank(op, L, float(lmax), c, pin(x), cdt)[0], axis=1)


def _bank(op: LaplacianOp, L: LaplacianOp, lmax: float, c, xin,
          carry_dtype=None, keep_terms: bool = False):
    """``(acc, slab)``: the bank of :func:`cheby_op` on ``op`` (``L``
    hoisted) for ``xin`` in its internal order, and with ``keep_terms``
    every term ``T̃_k x`` in one (m1, N, ...) slab (else None); the same
    steps and groups either way, so the same bits. Where autograd records
    it (``c`` or ``xin`` requires grad: the plain recurrence on the CPU),
    each term is a tensor of its own (:func:`_grouped_steps`)."""
    nf, m1 = c.shape
    t_old, t_cur, step = _start(op, lmax, xin, carry_dtype)
    slab = None
    if keep_terms:
        slab = torch.empty((m1,) + t_cur.shape, dtype=t_cur.dtype,
                           device=t_cur.device)
        slab[0].copy_(t_old)
        slab[1].copy_(t_cur)
        t_old, t_cur = slab[0], slab[1]
    cT = c.T.contiguous()                       # row k: c[:, k]
    acc = (0.5 * c[:, 0]).reshape((nf,) + (1,) * xin.ndim) * xin[None]
    cheby_kernel.cheby_acc_group(acc, t_cur[None], cT[1:2])
    if m1 > 2:
        g = acc_group(m1 - 2, xin.numel(), xin.dtype, t_cur.dtype,
                      _operator_bytes(L.offdiag), nf)
        _grouped_steps(step, m1, t_old, t_cur, g,
                       lambda ring, k, size, start: cheby_kernel
                       .cheby_acc_group(acc, ring, cT[k:k + size], start),
                       slab, fresh=slab is None and torch.is_grad_enabled()
                       and (c.requires_grad or xin.requires_grad))
    return acc, slab


def _internal(off):
    """The off-diagonal in its internal order: a relabeled chunked or
    windowed matrix without its permutes (as :meth:`LaplacianOp.hoisted`
    gives it)."""
    if isinstance(off, SCALED_OUTPUT) and off.perm is not None:
        return dataclasses.replace(off, perm=None, iperm=None)
    return off


class _ChebyOp(torch.autograd.Function):
    """:func:`cheby_op` under autograd, on every format: the bank's
    gradients with respect to the off-diagonal's value leaves (``vals``,
    the first, and ``*more``: its ``buffers()``, the leaves or the chunked
    format's flat slot buffer and tiers), the diagonal, λmax (a tensor),
    ``c`` and ``x``, on both devices. ``diag`` and ``x`` come in
    the operator's internal order (:meth:`LaplacianOp.hoisted`), and the
    result goes out in it; ``L`` is the operator as the caller gave it,
    which the group rule reads (:func:`_operator_bytes`). The leaves are
    inputs of their own, so that autograd carries their cotangents back to
    the caller's tensors (through :func:`laplacian_op` to W's values on a
    CSR).

    The forward is :func:`cheby_op`'s recurrence on the operator rebuilt
    from the leaves (``with_leaves``: what the kernels read is the leaves),
    with every term kept in one (m+1, N, ...) slab where the leaves, the
    diagonal, λmax or ``c`` require grad (the same steps and groups, so
    the same bits as the bank autograd does not record), and the ring of
    terms where ``x`` alone does: x̄ reads no term. The backward is
    :func:`_operator_grads`."""

    @staticmethod
    def forward(ctx, L, vals, diag, lmax, c, x, *more):
        ctx.L, ctx.lmax = L, float(lmax)
        ctx.lmax_like = lmax if isinstance(lmax, torch.Tensor) else None
        op = LaplacianOp(offdiag=_internal(L.offdiag).with_buffers(
            (vals,) + more), diag=diag, lap_type=L.lap_type)
        need = ctx.needs_input_grad
        acc, slab = _bank(op, L, ctx.lmax, c, x,
                          keep_terms=any(need[1:5]) or any(need[6:]))
        ctx.save_for_backward(vals, diag, c, slab, *more)
        return acc

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        vals, diag, c, slab, *more = ctx.saved_tensors
        L = LaplacianOp(offdiag=_internal(ctx.L.offdiag).with_buffers(
            (vals, *more)), diag=diag, lap_type=ctx.L.lap_type)
        need = ctx.needs_input_grad
        grads = _operator_grads(L, ctx.lmax, c, slab, gout,
                                need[1] or any(need[6:]), *need[2:6])
        leaves_bar = grads[0] or (None,) * (1 + len(more))
        lmax_bar = grads[2]
        if lmax_bar is not None:
            lmax_bar = lmax_bar.to(ctx.lmax_like).reshape(
                ctx.lmax_like.shape)
        return (None, leaves_bar[0], grads[1], lmax_bar, grads[3], grads[4],
                *leaves_bar[1:])


def _operator_grads(L: LaplacianOp, lmax: float, c, slab, gout,
                    need_vals: bool, need_diag: bool, need_lmax: bool,
                    need_c: bool, need_x: bool, pair=None, gout_last=None):
    """``(leaves̄, diag̅, λ̄, c̄, x̄)`` of the bank ``cheby_op(L, lmax, c, x)``
    on ``L`` (in its internal order) for its cotangent ``gout`` (Nf, N,
    ...), each None where it is not needed, ``leaves̄`` a tuple with a
    cotangent for each of the off-diagonal's :meth:`leaves`, from the
    forward's terms ``slab[k] = T̃_k x`` (None where x̄ alone is needed).
    ``pair``: L's off-diagonal and its transpose
    (:func:`~pygsp_tpu_torch.core.sparse.entry_pair`, made here by
    default), whose ``to_leaves`` say which leaves the cotangents reach;
    ``gout_last``: ``gout`` with its filter axis last, contiguous, where
    the caller holds it (else c̄ takes a copy).

    With L̃ = (L − a2)/a1, a1 = a2 = λmax/2, and c' = c with 0.5 at k = 0:

    - ``G_k = Σ_f c'[f, k] ḡ_f``, each added in place by
      :func:`~pygsp_tpu_torch.core.cheby_kernel.cheby_acc_group` with ḡ's
      Nf filters as its group of terms (no copy of ḡ);
    - the adjoint terms, the Clenshaw recurrence on the shifted step of
      the transpose (L̃ itself for symmetric weights),
      ``u_k = G_k + 2 L̃ᵀ u_{k+1} − u_{k+2}`` for k = m .. 1 with
      ``u_{m+1} = u_{m+2} = 0``, three buffers;
    - step k's share of the off-diagonal's cotangent,
      ``α·⟨u_{k+1}[i], t_k[j]⟩`` for its entry (i, j), and the
      diagonal's: α = 2/a1 for k ≥ 1, 1/a1 for k = 0 (the cotangent of
      the unscaled values, though the step multiplies a scaled copy). How
      depends on the format (:func:`_adjoint`): on a CSR, and on the CSR
      view of an ELL, chunked or windowed matrix's live slots, the SDDMM
      or kernel A's fused entry; on a banded matrix, one batched product
      of the tile pairs;
    - ``x̄ = G_0 + L̃ᵀ u_1 − u_2``;
    - ``c̄[f, k] = ⟨t_k, ḡ_f⟩`` with 0.5 at k = 0, one
      :func:`~pygsp_tpu_torch.core.cheby_kernel.cheby_dot_group` over the
      slab, on ``gout_last`` or a copy of ḡ with its filter axis last that
      is freed before the adjoint;
    - ``λ̄ = −(1/λmax)·[⟨u_1, t_1 + t_0⟩ + Σ_{k=1}^{m−1} ⟨u_{k+1},
      t_{k+1} + 2 t_k + t_{k−1}⟩]`` (∂L̃/∂λmax = −(L̃ + 1)/λmax), from
      ``cheby_dot_group`` with u as a one-filter ḡ.

    Memory beside the slab and ḡ: ḡ's copy for c̄ (Nf units of (N, ...)),
    then the three adjoint terms (x̄ takes the first one freed), the
    step's SpMM output, and the format's transpose."""
    nf, m1 = c.shape
    m = m1 - 1
    a1 = a2 = lmax / 2
    gout = gout.contiguous()                             # (Nf, N, ...)
    dt, dev = gout.dtype, gout.device
    shape = gout.shape[1:]
    cp = c.to(dt).clone()
    cp[:, 0] *= 0.5
    cpT = cp.T.contiguous()                              # row k: c'[:, k]
    c_bar = None
    if need_c:
        c_bar = torch.empty((m1, nf), dtype=dt, device=dev)
        cheby_kernel.cheby_dot_group(
            c_bar, gout.movedim(0, -1).contiguous() if gout_last is None
            else gout_last, slab)
        c_bar[0] *= 0.5
        c_bar = c_bar.T.to(c.dtype)
    need_w = need_vals or need_diag
    if not (need_w or need_lmax or need_x):
        return None, None, None, c_bar, None

    def add_g(u, k):
        """u += G_k: ḡ's filters as one group of Nf terms."""
        cheby_kernel.cheby_acc_group(u[None], gout, cpT[k].reshape(nf, 1))

    adj = _adjoint(L, slab, shape, dt, need_w, a1, pair)
    # ⟨u_{k+1}, t_{k-1}⟩, ⟨u_{k+1}, t_k⟩, ⟨u_{k+1}, t_{k+1}⟩ for step k
    lam = torch.zeros((m, 3, 1), dtype=dt, device=dev) if need_lmax else None

    def step_cotangent(u, k):
        """What step k (t_{k+1} from t_k) gives once u = u_{k+1} is
        formed, its share of the cotangents unless the step that reads u
        takes it."""
        if need_w and not adj.fused:
            adj.share(u, k)
        if need_lmax:                   # k = 0: ⟨u_1, t_0⟩, ⟨u_1, t_1⟩
            cheby_kernel.cheby_dot_group(lam[k] if k else lam[0, 1:],
                                         u[..., None], slab, max(k - 1, 0))

    step2 = adj.step(2.0 / a1, a2)             # 2 L̃ᵀ u − u_old
    u_next2 = torch.zeros(shape, dtype=dt, device=dev)         # u_{m+1}
    u_next = torch.zeros(shape, dtype=dt, device=dev)
    add_g(u_next, m)                                           # u_m = G_m
    step_cotangent(u_next, m - 1)
    free = None
    for k in range(m - 1, 0, -1):              # u_k, then step k - 1's share
        u = torch.empty(shape, dtype=dt, device=dev) if free is None else free
        step2(u_next, u_next2, u, k)
        add_g(u, k)
        step_cotangent(u, k - 1)
        free, u_next2, u_next = u_next2, u_next, u

    del step2                           # and its scaled copy of Lᵀ
    x_bar = None
    if need_x:
        x_bar = torch.empty(shape, dtype=dt, device=dev) if free is None \
            else free
        adj.step(1.0 / a1, a2)(u_next, u_next2, x_bar, 0)     # L̃ᵀu_1 − u_2
        add_g(x_bar, 0)
    elif adj.fused:                     # u_1's share, which x̄'s step took
        adj.share_t(u_next)
    leaves_bar = diag_bar = None
    if need_w:
        leaves_bar, diag_bar = adj.finish()
    lmax_bar = None
    if need_lmax:
        weights = torch.tensor([[0.0, 1.0, 1.0]] + [[1.0, 2.0, 1.0]] * (m - 1),
                               dtype=dt, device=dev)
        lmax_bar = -(lam[..., 0] * weights).sum() / lmax
    return (leaves_bar if need_vals else None,
            diag_bar if need_diag else None, lmax_bar, c_bar, x_bar)


def _adjoint(L: LaplacianOp, slab, shape, dt, need_w: bool, a1: float,
             pair=None):
    """The off-diagonal's part of :func:`_operator_grads` for ``L``'s
    format, on ``pair`` (by default
    :func:`~pygsp_tpu_torch.core.sparse.entry_pair` of L's off-diagonal):
    a :class:`_BandedAdjoint` for banded matrices, else a
    :class:`_CSRAdjoint` on the CSR itself or on the CSR view of an ELL,
    chunked or windowed matrix's live slots
    (:func:`~pygsp_tpu_torch.core.sparse.grad_edges`)."""
    if pair is None:
        pair = entry_pair(L.offdiag, dt)
    if isinstance(pair.fwd, BandedMatrix):
        return _BandedAdjoint(L, pair, slab, shape, dt, need_w, a1)
    return _CSRAdjoint(L, pair, slab, shape, dt, need_w, a1)


class _CSRAdjoint:
    """The adjoint steps and the values' cotangent on a CSR ``off``
    (``pair.fwd``; ``pair.bwd``, its transpose, with values). The values'
    cotangent is
    taken in ``off``'s entry order by :func:`~pygsp_tpu_torch.core.
    csr_kernel.csr_sddmm` a step, or, above
    :data:`~pygsp_tpu_torch.core.csr_kernel.NARROW_WIDTH` columns
    (:func:`~pygsp_tpu_torch.core.csr_kernel.fused_width`), in the
    transpose's entry order by the transpose's SpMM that forms ``u_k``
    from ``u_{k+1}`` (one launch of :func:`~pygsp_tpu_torch.core.
    csr_kernel.csr_spmm_sddmm`), u_1's share riding in x̄'s step or taken
    by one ``csr_sddmm`` on the transpose where x̄ is not needed (the same
    products, so the same bits as in ``off``'s order). Either way m
    launches add the shares in the order k = m−1 .. 0. The pair's
    ``to_leaves_t`` and ``to_leaves`` take a cotangent in the transpose's
    order and in ``off``'s to the leaves."""

    def __init__(self, L, pair, slab, shape, dt, need_w, a1):
        off = pair.fwd
        self.off, self.slab, self.shape = off, slab, shape
        self.place_t, self.place = pair.to_leaves_t, pair.to_leaves
        self.n = shape[0]
        dev = L.device
        self.Lt = LaplacianOp(offdiag=pair.bwd, diag=L.diag,
                              lap_type=L.lap_type)
        self.fused = need_w and csr_kernel.fused_width(math.prod(shape[1:]),
                                                       dt)
        self.vals_bar = torch.zeros(off.rows.shape, dtype=dt, device=dev) \
            if need_w else None
        self.diag_bar = torch.zeros_like(L.diag) if need_w else None
        self.alphas = (torch.full((), 1.0 / a1, dtype=dt, device=dev),
                       torch.full((), 2.0 / a1, dtype=dt, device=dev))

    def share(self, u, k):
        """Step k's share of the cotangents, u = u_{k+1}, in off's order."""
        n = self.n
        csr_kernel.csr_sddmm(self.off.rows, self.off.cols, u.reshape(n, -1),
                             self.slab[k].reshape(n, -1), self.vals_bar,
                             self.alphas[k > 0], self.diag_bar)

    def share_t(self, u):
        """u_1's share in the transpose's order (the fused route)."""
        n, off_t = self.n, self.Lt.offdiag
        csr_kernel.csr_sddmm(off_t.rows, off_t.cols,
                             self.slab[0].reshape(n, -1), u.reshape(n, -1),
                             self.vals_bar, self.alphas[0], self.diag_bar)

    def step(self, scale, a2):
        """``step(u, u_old, out, k)``: ``scale·(Lᵀ − a2)·u − u_old`` into
        out in :meth:`LaplacianOp.shifted_step`'s arithmetic, and where
        fused step k's share of the cotangents for u = u_{k+1} in the same
        SpMM."""
        if not self.fused:
            plain = self.Lt.shifted_step(scale, a2)
            return lambda u, u_old, out, k: plain(u, u_old, out)
        factor = self.Lt.shifted(scale, a2)
        f_off, n, slab = factor.offdiag, self.n, self.slab
        one = torch.ones((), dtype=factor.diag.dtype, device=f_off.device)

        def step(u, u_old, out, k):
            y = csr_kernel.csr_spmm_sddmm(
                f_off.rowptr, f_off.cols, f_off.vals, u.reshape(n, -1),
                slab[k].reshape(n, -1), self.vals_bar, self.alphas[k > 0],
                self.diag_bar)
            return cheby_kernel.cheby_step(y.reshape(self.shape), u, u_old,
                                           factor.diag, one, out)

        return step

    def finish(self):
        """``(leaves̄, diag̅)``."""
        place = self.place_t if self.fused else self.place
        return place(self.vals_bar), self.diag_bar


class _BandedAdjoint:
    """The adjoint steps and the tiles' cotangent on a banded matrix of
    half bandwidth b. The adjoint runs the banded kernel on the
    transposed tiles (``pair.bwd``,
    :func:`~pygsp_tpu_torch.core.sparse.transpose_tiles`), made once a
    backward. Step k's share of the tiles' cotangent is
    ``α·u_{k+1}[block n]·t_k[block n + d − b]ᵀ`` for every tile (n, d):
    one ``torch.baddbmm`` over the nb tile rows
    (:func:`~pygsp_tpu_torch.core.sparse.band_operands`: tile row n
    multiplies u's block by t's 2b + 1 blocks around it). It runs in
    float32, not TF32 (:func:`~pygsp_tpu_torch.core.sparse.fp32_matmul`).
    The JAX package computes this product as the transpose of its XLA
    einsum (``pygsp_tpu/core/sparse.py:565-587``), outside any Pallas
    kernel. The diagonal's cotangent is the diagonal of the d = b tiles'.
    Every tile entry gets its cotangent, as in the JAX package: the tiles
    hold no padding of their own."""

    fused = False

    def __init__(self, L, pair, slab, shape, dt, need_w, a1):
        nb, nd = pair.fwd.tiles.shape[:2]
        self.Lt = LaplacianOp(offdiag=pair.bwd, diag=L.diag,
                              lap_type=L.lap_type)
        self.to_leaves = pair.to_leaves
        self.slab, self.n, self.nb = slab, shape[0], nb
        self.b = pair.fwd.half_bw
        self.alphas = (1.0 / a1, 2.0 / a1)
        self.acc = (torch.zeros((nb, BAND_TILE, nd * BAND_TILE), dtype=dt,
                                device=L.device) if need_w else None)

    def step(self, scale, a2):
        plain = self.Lt.shifted_step(scale, a2)
        return lambda u, u_old, out, k: plain(u, u_old, out)

    def share(self, u, k):
        """Step k's share of the tiles' cotangent, u = u_{k+1}."""
        ub, win = band_operands(u, self.slab[k], self.b, self.nb)
        with fp32_matmul():
            self.acc.baddbmm_(ub, win.transpose(1, 2),
                              alpha=self.alphas[k > 0])

    def finish(self):
        tiles_bar = band_tiles(self.acc, self.b)
        diag_bar = tiles_bar[:, self.b].diagonal(dim1=-2, dim2=-1).reshape(-1)
        return self.to_leaves(tiles_bar), diag_bar[:self.n].contiguous()


def cheby_op_intermediates(L: LaplacianOp, lmax, c, x: torch.Tensor):
    """Like :func:`cheby_op` but also returns every recurrence term
    ``T̃_k s`` for k = 0..m, stacked: ``(acc, terms)``."""
    L, c, x, _ = _prepare(L, c, x)
    op, pin, pout = L.hoisted()
    terms = torch.stack(list(_terms(op, float(lmax), pin(x), c.shape[1])))
    c = c.clone()
    c[:, 0] *= 0.5
    acc = (c.reshape(c.shape + (1,) * x.ndim) * terms[None]).sum(dim=1)
    return pout(acc, axis=1), pout(terms, axis=1)


def cheby_synthesis(L: LaplacianOp, lmax, c, x: torch.Tensor,
                    carry_dtype=None, carry_tol: float | None = None,
                    vals_dtype=None) -> torch.Tensor:
    """Synthesis: per-filter coefficients applied to per-filter signals,
    summed. ``c`` (Nf, m+1), ``x`` (N, ..., Nf), feature axis last; returns
    (N, ...). One recurrence over the whole (N, ..., Nf) block, each step's
    term contracted over the filter axis into the accumulator in one pass
    (:func:`~pygsp_tpu_torch.core.cheby_kernel.cheby_acc_contract`).
    ``carry_dtype``, ``carry_tol``, ``vals_dtype``: as in
    :func:`cheby_op`.

    Under autograd it differentiates with respect to the operator's value
    leaves, its diagonal, a tensor ``lmax``, ``c`` and ``x``, on every
    format and both devices (:class:`_ChebySynthesis`: no term kept
    forward; backward the analysis bank of the cotangent on the
    transpose). On the CPU a gradient through ``x`` alone runs the plain
    recurrence under autograd, which differentiates again. The bf16 modes
    are not differentiated: under the Function's route they raise
    ``ValueError``."""
    c = torch.atleast_2d(torch.as_tensor(c))
    nf = c.shape[0]
    if x.shape[-1] != nf:
        raise ValueError(f'last axis of x ({x.shape[-1]}) must equal the '
                         f'number of filters ({nf})')
    L, c, x, cdt = _prepare(L, c, x, carry_dtype, carry_tol, vals_dtype)
    op, pin, pout = L.hoisted()
    recorded = _records(L, c, x, lmax)
    if recorded and (x.device.type != 'cpu' or c.requires_grad
                     or _operator_records(L, lmax)):
        if cdt is not None or (vals_dtype is not None
                               and L.offdiag.dtype != x.dtype):
            raise ValueError(_BF16_GRAD.format('cheby_synthesis'))
        vals, *more = L.offdiag.buffers()
        return pout(_ChebySynthesis.apply(L, vals, op.diag, lmax, c, pin(x),
                                          *more))
    return pout(_synthesis(op, lmax, c, pin(x), cdt, reuse=not recorded))


class _ChebySynthesis(torch.autograd.Function):
    """:func:`cheby_synthesis` under autograd, on every format and both
    devices, with the inputs of :class:`_ChebyOp` (``x`` (N, ..., Nf) in
    the internal order). The forward is :func:`_synthesis` on the operator
    rebuilt from the leaves, so the same bits as the unrecorded call; it
    keeps no term, only ``x`` where the operator, λmax or ``c`` need it.

    The synthesis ``y = Σ_f Σ_k c'[f, k] T̃_k(L) x_f`` has, for the
    cotangent ȳ, the analysis bank on the transpose as its adjoint:
    ``⟨ȳ, y⟩ = Σ_f ⟨x_f, Σ_k c'[f, k] T̃_k(Lᵀ) ȳ⟩``. So the backward is

    - ``x̄ = cheby_op(Lᵀ, λmax, c, ȳ)`` with the filter axis moved last
      (:func:`_bank` on Lᵀ, its terms kept in one (m+1, N, ...) slab where
      anything but x̄ is needed);
    - c̄, diag̅, λ̄ and the off-diagonal's cotangent: that bank's own
      (:func:`_operator_grads` on Lᵀ with ``x`` as the cotangent), an entry
      (i, j) of Lᵀ's being entry (j, i) of L's, so the pair of matrices
      (:func:`~pygsp_tpu_torch.core.sparse.entry_pair`) is taken swapped
      and nothing new is built.

    Lᵀ is the CSR transpose on a CSR, the CSR view of the live slots'
    transpose on an ELL, chunked or windowed matrix, the transposed tiles
    on a banded one. The backward holds the slab, x̄ and the adjoint's
    buffers; the direct route would keep m+1 terms of (N, ..., Nf)."""

    @staticmethod
    def forward(ctx, L, vals, diag, lmax, c, x, *more):
        ctx.L, ctx.lmax = L, float(lmax)
        ctx.lmax_like = lmax if isinstance(lmax, torch.Tensor) else None
        op = LaplacianOp(offdiag=_internal(L.offdiag).with_buffers(
            (vals,) + more), diag=diag, lap_type=L.lap_type)
        need = ctx.needs_input_grad
        ctx.save_for_backward(vals, diag, c, x if any(need[1:5])
                              or any(need[6:]) else None, *more)
        return _synthesis(op, ctx.lmax, c, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ybar):
        vals, diag, c, x, *more = ctx.saved_tensors
        off = _internal(ctx.L.offdiag).with_buffers((vals, *more))
        need = ctx.needs_input_grad
        need_vals = need[1] or any(need[6:])
        ybar = ybar.contiguous()
        pair = entry_pair(off, ybar.dtype).swapped()
        Lt = LaplacianOp(offdiag=pair.fwd, diag=diag, lap_type=ctx.L.lap_type)
        keep = need_vals or any(need[2:5])
        acc, slab = _bank(Lt, Lt, ctx.lmax, c, ybar, keep_terms=keep)
        x_bar = acc.movedim(0, -1) if need[5] else None
        grads = (None,) * 4
        if keep:
            grads = _operator_grads(Lt, ctx.lmax, c, slab, x.movedim(-1, 0),
                                    need_vals, need[2], need[3], need[4],
                                    False, pair, x)
        leaves_bar = grads[0] or (None,) * (1 + len(more))
        lmax_bar = grads[2]
        if lmax_bar is not None:
            lmax_bar = lmax_bar.to(ctx.lmax_like).reshape(
                ctx.lmax_like.shape)
        return (None, leaves_bar[0], grads[1], lmax_bar, grads[3], x_bar,
                *leaves_bar[1:])


def _synthesis(op: LaplacianOp, lmax, c, xin, carry_dtype=None,
               reuse: bool = True):
    """The synthesis recurrence on ``op`` in its internal order, for ``xin``
    (N, ..., Nf) in that order; returns (N, ...) in that order. ``xin`` is
    read, never written. A step writes into the buffer of the term three
    back, unless ``reuse`` is off: autograd, which records the plain
    recurrence on the CPU, keeps the terms it multiplied."""
    t_old, t_cur, step = _start(op, float(lmax), xin, carry_dtype)
    odt = xin.dtype
    acc = (0.5 * c[:, 0] * t_old.to(odt) + c[:, 1] * t_cur.to(odt)).sum(-1)
    cT = c.T.contiguous()
    free = None
    for k in range(2, c.shape[1]):
        out = torch.empty_like(t_cur) if free is None else free
        t_new = step(t_cur, t_old, out)
        cheby_kernel.cheby_acc_contract(acc, t_new, cT[k])
        free = t_old if k > 2 and reuse else None
        t_old, t_cur = t_cur, t_new
    return acc


# ---------------------------------------------------------------------------
# the fixed-graph VJP: training through the recurrence in constant memory
# ---------------------------------------------------------------------------

def cheby_op_fixed_graph(L: LaplacianOp, lmax, c, x: torch.Tensor
                         ) -> torch.Tensor:
    """:func:`cheby_op` with a constant-memory backward, for training.

    Autograd through the K-step recurrence would keep every carried term,
    3K (N, S) buffers (48.3 GB in float32 at N = 2^20, S = 128, K = 30);
    on the card it cannot see the kernels at all. The bank is linear in
    ``c`` and ``x``, so its adjoint needs none of them
    (``pygsp_tpu/ops/chebyshev.py:361-456``):

    - ``x̄ = Σ_f Σ_k c'[f, k] T̃_k ḡ_f``, the same series applied to the
      cotangent bank (the shifted operator is symmetric):
      :func:`cheby_synthesis` of ḡ with its filter axis last;
    - ``c̄[f, k] = ⟨T̃_k x, ḡ_f⟩`` (0.5 at k = 0): one fresh recurrence on
      x in the operator's internal order, its terms contracted with the
      cotangents a group at a time
      (:func:`~pygsp_tpu_torch.core.cheby_kernel.cheby_dot_group`).

    The backward holds the recurrence state of one pass at a time, and
    computes the gradients of the inputs that require grad only. ``L`` and
    ``lmax`` get none, as in the JAX package: to differentiate through the
    graph's weights, call :func:`cheby_op` on a CSR operator, whose
    backward has the SpMM's own (an SDDMM). ``c`` (Nf, m+1) or (m+1,) and
    ``x`` (N, ...) are as in :func:`cheby_op`; c̄ has c's shape and dtype,
    x̄ x's.
    """
    return _FixedGraph.apply(L, lmax, torch.as_tensor(c), x)


class _FixedGraph(torch.autograd.Function):
    """:func:`cheby_op_fixed_graph`'s forward and backward. The context
    keeps L, λmax, c and x, nothing of the recurrence."""

    @staticmethod
    def forward(ctx, L, lmax, c, x):
        ctx.L, ctx.lmax = L, lmax
        ctx.save_for_backward(c, x)
        return cheby_op(L, lmax, c, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        c, x = ctx.saved_tensors
        c_bar, x_bar = _fixed_graph_grads(ctx.L, ctx.lmax, c, x, gout,
                                          *ctx.needs_input_grad[2:])
        return None, None, c_bar, x_bar


def _fixed_graph_grads(L: LaplacianOp, lmax, c, x, gout, need_c: bool,
                       need_x: bool):
    """``(c̄, x̄)`` of the bank ``cheby_op(L, lmax, c, x)`` for its
    cotangent ``gout`` (Nf, N, ...), each None where it is not needed. x is
    promoted to the operator's dtype, as in the JAX package
    (``pygsp_tpu/ops/chebyshev.py:411-412``)."""
    L, xp = _promote(L, x)
    dt = xp.dtype
    c2 = torch.atleast_2d(c).to(dtype=dt, device=xp.device)
    op, pin, pout = L.hoisted()
    # the cotangent bank with its filter axis last, in the operator's
    # internal order: one copy at most, read by both passes
    gin = pin(gout.to(dt).movedim(0, -1)).contiguous()
    c_bar = x_bar = None
    if need_x:
        x_bar = pout(_synthesis(op, lmax, c2, gin)).to(x.dtype)
    if need_c:
        c_bar = _coeff_grads(op, L, lmax, c2.shape[1],
                             pin(xp).contiguous(), gin)
        c_bar = c_bar.to(c).reshape(c.shape)
    return c_bar, x_bar


def _coeff_grads(op: LaplacianOp, L: LaplacianOp, lmax, m1: int, xin, gin):
    """``c̄ (Nf, m1)``, ``c̄[f, k] = ⟨T̃_k x, ḡ_f⟩`` with 0.5 at k = 0, for
    ``xin`` (N, ...) and ``gin`` (N, ..., Nf) in the internal order of
    ``op`` (``L`` hoisted): the recurrence of :func:`cheby_op` with its
    ring and its groups (the same ``g``), each group of terms contracted
    with the cotangents in one pass, and terms 0 and 1 as groups of one
    (the JAX package's ``_cheby_coeff_grads_chunked``,
    ``pygsp_tpu/ops/chebyshev.py:707-736``)."""
    nf = gin.shape[-1]
    cbar_t = torch.empty((m1, nf), dtype=xin.dtype, device=xin.device)
    t_old, t_cur, step = _start(op, float(lmax), xin)
    cheby_kernel.cheby_dot_group(cbar_t[0:1], gin, t_old[None])
    cheby_kernel.cheby_dot_group(cbar_t[1:2], gin, t_cur[None])
    if m1 > 2:
        g = acc_group(m1 - 2, xin.numel(), xin.dtype, xin.dtype,
                      _operator_bytes(L.offdiag), nf)
        _grouped_steps(step, m1, t_old, t_cur, g,
                       lambda ring, k, size, start: cheby_kernel
                       .cheby_dot_group(cbar_t[k:k + size], gin, ring, start))
    cbar_t[0] *= 0.5
    return cbar_t.T


def cheby_rect(L: LaplacianOp, lmax, bounds, x: torch.Tensor,
               order: int = 30) -> torch.Tensor:
    """Ideal band-pass filtering with closed-form Chebyshev coefficients:
    the analytic Chebyshev series of the indicator of ``bounds = [b1, b2]``
    ⊂ [0, lmax]. On the chunked and windowed formats the recurrence is the
    hot path's (internal order, scale on the SpMM output); on the others
    the reference's arithmetic order, ``sc·(L t − a2·t) − t_old``.

    Under autograd it differentiates with respect to ``x``, the operator's
    leaves and diagonal, and tensors ``lmax`` and ``bounds``: on the
    chunked and windowed formats through :func:`cheby_op` with the
    coefficients ``[2·c0, c1, ...]`` (so that their cotangent reaches
    ``bounds`` and λmax through the closed form; other summation orders
    than the unrecorded call's), on the others through :func:`matvec`'s
    SpMM."""
    L, x = _promote(L, torch.as_tensor(x))
    lmax_t = torch.as_tensor(lmax, dtype=x.dtype, device=x.device)
    bounds = torch.as_tensor(bounds, dtype=x.dtype, device=x.device)
    b1, b2 = torch.arccos(2.0 * bounds / lmax_t - 1.0)
    c0 = (b1 - b2) / torch.pi
    c1 = 2.0 / torch.pi * (torch.sin(b1) - torch.sin(b2))
    ks = torch.arange(2, order + 1, dtype=x.dtype, device=x.device)
    coeffs = 2.0 / (ks * torch.pi) * (torch.sin(ks * b1) - torch.sin(ks * b2))

    if isinstance(L.offdiag, SCALED_OUTPUT):
        c = torch.cat([(2.0 * c0)[None], c1[None], coeffs])[None]
        if _records(L, c, x, lmax):
            return cheby_op(L, lmax, c, x)[0]
        op, pin, pout = L.hoisted()
        terms = _terms(op, float(lmax), pin(x), order + 1)
        acc = c0 * next(terms) + c1 * next(terms)
        for ck, t in zip(coeffs, terms):
            acc = acc + ck * t
        return pout(acc)

    a1 = a2 = float(lmax) / 2
    sc = 2.0 / a1
    t_old = x
    t_cur = (matvec(L, x) - a2 * x) / a1
    acc = c0 * x + c1 * t_cur
    for ck in coeffs:
        t_new = sc * (matvec(L, t_cur) - a2 * t_cur) - t_old
        acc = acc + ck * t_new
        t_old, t_cur = t_cur, t_new
    return acc


def jackson_cheby_coeff(filter_bounds, delta_lambda, m: int, *,
                        dtype=None, device='cuda'):
    """Jackson-damped Chebyshev coefficients of an ideal band-pass between
    the two ``filter_bounds`` within the spectrum ``delta_lambda = [λmin,
    λmax]``. Returns ``(ch, jch)``, the raw and damped coefficient vectors
    of length m + 1 (``dtype``: default the default float dtype)."""
    device = check_device(device, 'jackson_cheby_coeff')
    dtype = torch.get_default_dtype() if dtype is None else dtype
    a, b = (torch.as_tensor(v, dtype=dtype, device=device)
            for v in delta_lambda)
    fa, fb = (torch.as_tensor(v, dtype=dtype, device=device)
              for v in filter_bounds)
    # affine map of the band onto [-1, 1]
    fa = (2.0 * fa - a - b) / (b - a)
    fb = (2.0 * fb - a - b) / (b - a)

    ks = torch.arange(1, m + 1, dtype=dtype, device=device)
    ch0 = 2.0 * (torch.arccos(fa) - torch.arccos(fb)) / torch.pi
    chk = (2.0 / (torch.pi * ks)) * (torch.sin(ks * torch.arccos(fa))
                                      - torch.sin(ks * torch.arccos(fb)))
    ch = torch.cat([ch0[None], chk])

    # Jackson damping factors (gamma_JACK in the reference)
    alpha = torch.pi / (m + 2.0)
    kk = torch.arange(0, m + 1, dtype=dtype, device=device)
    sin_a = torch.sin(torch.as_tensor(alpha, dtype=dtype))
    cos_a = torch.cos(torch.as_tensor(alpha, dtype=dtype))
    gamma = ((1.0 - kk / (m + 2.0)) * sin_a * torch.cos(kk * alpha)
             + (1.0 / (m + 2.0)) * cos_a * torch.sin(kk * alpha)) / sin_a
    return ch, ch * gamma
