"""Conjugate gradients over a whole block of right-hand sides.

Counterpart of ``jax.scipy.sparse.linalg.cg``, which the JAX package's
``learning.py`` and ``reduction.py`` call, in its algorithm (jax 0.9.0,
``jax/_src/scipy/sparse/linalg.py``: ``_cg_solve`` and ``_isolve``): one CG
over the whole (N, S) block, whose α and β come from dot products over all
of the block's elements, not one CG per column; it stops when
``‖r‖² ≤ max(tol²·‖b‖², atol²)`` over the block or after ``maxiter``
iterations. The operator is any callable; on a graph it is built on
:func:`~pygsp_tpu_torch.core.operators.matvec`, one CSR SpMM kernel launch
an application on the card. The stopping test is read on the host once an
iteration, where the JAX package runs a ``lax.while_loop`` on the device.
"""

from __future__ import annotations

import torch


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The dot product over all elements, as a 0-d tensor."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def cg(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, tol=1e-5,
       atol=0.0, maxiter: int | None = None):
    """Solve ``A x = b`` for a symmetric positive definite ``A``.

    Parameters
    ----------
    A : callable, ``A(x)`` of x's shape.
    b : right-hand side, any shape; one CG over all of it.
    x0 : start (default zeros).
    tol, atol : stop when ``‖r‖ ≤ max(tol·‖b‖, atol)``, norms over all
        of b's elements.
    maxiter : the most iterations (default ``10 · b.numel()``).

    Returns
    -------
    ``(x, iterations)``: the solution and the number of iterations run
    (``jax.scipy.sparse.linalg.cg`` returns ``None`` in its place). A runs
    once before the first iteration and once an iteration.

    Examples
    --------
    >>> import torch
    >>> A = torch.tensor([[4., 1.], [1., 3.]], dtype=torch.float64)
    >>> x, n = cg(lambda v: A @ v, torch.tensor([1., 2.], dtype=torch.float64))
    >>> [round(float(v), 6) for v in x], n
    ([0.090909, 0.636364], 2)
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if tuple(x0.shape) != tuple(b.shape):
        raise ValueError(f'arrays in x0 and b must have matching shapes: '
                         f'{tuple(x0.shape)} vs {tuple(b.shape)}')
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = torch.clamp(tol ** 2 * _vdot(b, b), min=atol ** 2)
    x = x0.clone()
    r = b - A(x0)
    p = r.clone()
    gamma = _vdot(r, r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = A(p)
        alpha = gamma / _vdot(p, Ap)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, -alpha)
        gamma_new = _vdot(r, r)
        p = torch.addcmul(r, p, gamma_new / gamma)
        gamma = gamma_new
        k += 1
    return x, k
