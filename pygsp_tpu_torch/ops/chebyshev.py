"""Chebyshev polynomial filtering, the hot path.

Counterpart of :mod:`pygsp_tpu.ops.chebyshev` on the CSR, banded and
windowed formats. The three-term recurrence runs as a Python loop whose
state is ``(T_{k-1} s, T_k s, accumulators for all Nf filters)``, so the K
SpMMs are shared by the whole filter bank. On a windowed operator the whole
recurrence runs in the matrix's internal vertex order, as the JAX
package's ``_cheby_op_chunked`` does; the operator says how
(:meth:`~pygsp_tpu_torch.core.operators.LaplacianOp.hoisted`,
:meth:`~pygsp_tpu_torch.core.operators.LaplacianOp.shifted_step`).

Signal convention: ``x`` has shape ``(N, ...)``; ``cheby_op`` returns
``(Nf, N, ...)``.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core.operators import LaplacianOp, matvec
from pygsp_tpu_torch.utils import check_device


def cheby_coeff(evaluate, lmax, m: int = 30, grid_n: int | None = None,
                dtype=None, device='cuda'):
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


def _prepare(L: LaplacianOp, c, x, carry_dtype=None, vals_dtype=None):
    """Shared set-up: the format checks of the JAX package, one promoted
    dtype for the signal, the operator and the coefficients."""
    for name, value in (('carry_dtype', carry_dtype),
                        ('vals_dtype', vals_dtype)):
        if value is None or (name == 'carry_dtype' and value == x.dtype):
            continue
        L.refuse_bf16_mode(name)
    c = torch.atleast_2d(torch.as_tensor(c))
    if c.shape[1] < 2:
        raise ValueError('Chebyshev coefficients need order >= 1')
    dtype = torch.promote_types(x.dtype, L.dtype)
    if L.dtype != dtype:
        L = L.astype(dtype)
    return L, c.to(dtype=dtype, device=x.device), x.to(dtype)


def _recurrence(L: LaplacianOp, lmax: float, x, m1: int):
    """Yields the recurrence terms ``T̃_k x`` for k = 0..m1-1 on [0, lmax],
    holding only the last two."""
    a1 = a2 = lmax / 2
    t_old = x
    yield t_old
    t_cur = (matvec(L, x) - a2 * x) / a1
    yield t_cur
    # 2/a1 * (L - a2 I) t - t_old, in the format's own arithmetic
    step = L.shifted_step(2.0 / a1, a2)
    for _ in range(2, m1):
        t_old, t_cur = t_cur, step(t_cur, t_old)
        yield t_cur


def cheby_op(L: LaplacianOp, lmax, c, x: torch.Tensor,
             carry_dtype=None, carry_tol: float | None = None,
             vals_dtype=None) -> torch.Tensor:
    """Apply a Chebyshev-approximated filter bank: ``(Nf, m+1), (N, ...) -> (Nf, N, ...)``.

    Shifted recurrence on [0, lmax] with the 0.5·c0 convention, all Nf
    filters accumulated from the shared recurrence terms, in the
    operator's internal vertex order (:meth:`LaplacianOp.hoisted`).
    ``carry_dtype`` and ``vals_dtype`` (the bf16 modes) raise
    ``ValueError`` on the CSR and banded formats, as in the JAX package,
    and ``NotImplementedError`` on the windowed one, where they are not
    ported yet. The accumulator is updated in place, which saves one
    (Nf, N, ...) temporary per step.
    """
    L, c, x = _prepare(L, c, x, carry_dtype, vals_dtype)
    op, pin, pout = L.hoisted()
    bshape = (c.shape[0],) + (1,) * x.ndim
    terms = _recurrence(op, float(lmax), pin(x), c.shape[1])
    acc = 0.5 * c[:, 0].reshape(bshape) * next(terms)[None]
    for k, t in enumerate(terms, start=1):
        acc.addcmul_(c[:, k].reshape(bshape), t[None])
    return pout(acc, axis=1)


def cheby_op_intermediates(L: LaplacianOp, lmax, c, x: torch.Tensor):
    """Like :func:`cheby_op` but also returns every recurrence term
    ``T̃_k s`` for k = 0..m, stacked: ``(acc, terms)``."""
    L, c, x = _prepare(L, c, x)
    op, pin, pout = L.hoisted()
    terms = torch.stack(list(_recurrence(op, float(lmax), pin(x),
                                         c.shape[1])))
    c = c.clone()
    c[:, 0] *= 0.5
    acc = (c.reshape(c.shape + (1,) * x.ndim) * terms[None]).sum(dim=1)
    return pout(acc, axis=1), pout(terms, axis=1)
