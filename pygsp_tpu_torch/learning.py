"""Semi-supervised learning on graphs (counterpart of
:mod:`pygsp_tpu.learning`).

Tikhonov regression solves one conjugate-gradient system over all the
signal's columns at once (:func:`~pygsp_tpu_torch.ops.cg.cg`, the port of
``jax.scipy.sparse.linalg.cg``); its operators are built on
:func:`~pygsp_tpu_torch.core.operators.matvec`, one CSR SpMM kernel launch
plus the diagonal an application on the card. The simplex-constrained
classifier is the JAX package's projected forward–backward splitting loop;
it reads its stopping value on the host once an iteration (the JAX package
runs a ``lax.while_loop`` on the device) and stops at the same iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsp_tpu_torch.core.operators import matvec
from pygsp_tpu_torch.ops.cg import cg
from pygsp_tpu_torch.utils import to_numpy


def _to_logits(x, n_classes=None):
    x = np.asarray(x).astype(int)
    k = (np.max(x) + 1) if n_classes is None else n_classes
    logits = np.zeros([len(x), k])
    logits[range(len(x)), x] = 1
    return logits


def regression_tikhonov(G, y, M, tau=0):
    """Solve ``argmin_x ‖Mx − y‖² + τ xᵀLx`` (τ > 0, one CG over all of y's
    columns) or the interpolation ``L_uu x_u = W_ul y_l`` that keeps the
    labelled values (τ = 0, CG on the masked operator, at most 1000
    iterations). ``y`` (N,) or (N, S) and the mask ``M`` (N,) are moved to
    the graph's device; the result is a tensor there, in the Laplacian's
    dtype.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, learning
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> mask = np.zeros(64, bool); mask[:32] = True
    >>> y = np.where(mask, 1.0, 0.0)      # a constant signal, half observed
    >>> out = learning.regression_tikhonov(G, y, mask, tau=0)
    >>> bool((out - 1.0).abs().max() < 1e-3)
    True
    """
    L = G.L
    y = torch.as_tensor(y, device=L.device).to(L.dtype)
    M_mask = torch.as_tensor(M, device=L.device).to(torch.bool)
    mf = M_mask.to(y.dtype)

    bshape = (-1,) + (1,) * (y.ndim - 1)
    mfb = mf.reshape(bshape)

    if tau > 0:
        y = torch.where(M_mask.reshape(bshape), y, 0)

        def op(x):
            return mfb * x + tau * matvec(L, x)

        sol, _ = cg(op, y)
        return sol
    if int(np.prod(np.shape(M))) != G.n_vertices:
        raise ValueError('M should be of size [G.n_vertices,]')
    yl = torch.where(M_mask.reshape(bshape), y, 0)
    # rhs_u = W_ul y_l = -(L y_masked) on the unknown rows
    rhs = -matvec(L, yl)
    ub = (~M_mask).to(y.dtype).reshape(bshape)
    rhs = ub * rhs

    def op(x):
        # L_uu x_u: the labelled entries zeroed in and out, the identity
        # on them
        return ub * matvec(L, ub * x) + mfb * x

    sol_u, _ = cg(op, rhs, maxiter=1000)
    return torch.where(M_mask.reshape(bshape), y, sol_u)


def classification_tikhonov(G, y, M, tau=0):
    """Labels → one-hot logits → :func:`regression_tikhonov`: (N, classes)
    scores.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, learning
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> mask = np.zeros(64, bool); mask[::2] = True
    >>> labels = (np.arange(64) >= 32).astype(float)
    >>> out = learning.classification_tikhonov(G, np.where(mask, labels, 0),
    ...                                        mask, tau=0.1)
    >>> tuple(out.shape)                  # one score column per class
    (64, 2)
    """
    y = to_numpy(y).copy()
    y[to_numpy(M) == False] = 0  # noqa: E712
    Y = _to_logits(y)
    return regression_tikhonov(G, Y, M, tau)


def _proj_simplex(v):
    """Euclidean projection of each row of v onto the probability simplex."""
    d = v.shape[1]
    u = torch.sort(v, dim=1, descending=True).values
    css = torch.cumsum(u, dim=1) - 1.0
    ind = torch.arange(1, d + 1, device=v.device, dtype=v.dtype)
    cond = u - css / ind > 0
    rho = torch.sum(cond, dim=1)
    lam = css[torch.arange(v.shape[0], device=v.device), rho - 1] / rho
    return torch.clamp(v - lam[:, None], min=0.0)


def classification_tikhonov_simplex(G, y, M, tau=0.1, maxit=500, tol=1e-8,
                                    verbosity=None):
    """Tikhonov classification with each vertex's scores on the probability
    simplex, by projected forward–backward splitting: at most ``maxit``
    iterations, until no score moves by more than ``tol`` (compared in the
    Laplacian's dtype, as the JAX package compares in its loop's).
    ``verbosity`` is accepted and ignored, as in the JAX package.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, learning
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> mask = np.zeros(64, bool); mask[::4] = True
    >>> labels = (np.arange(64) % 3).astype(float)
    >>> out = learning.classification_tikhonov_simplex(G, labels, mask)
    >>> bool(torch.allclose(out.sum(dim=1), torch.ones(64, dtype=out.dtype)))
    True
    """
    if tau <= 0:
        raise ValueError('Tau should be greater than 0.')

    L = G.L
    y = to_numpy(y).copy()
    M_np = to_numpy(M)
    y[M_np == False] = 0  # noqa: E712
    Y = torch.as_tensor(_to_logits(y), device=L.device).to(L.dtype)
    mf = torch.as_tensor(M_np, device=L.device).to(Y.dtype)[:, None]
    Y = Y * mf
    step = 0.5 / (1.0 + tau * G.lmax)

    def grad(x):
        return 2 * (mf * (mf * x - Y) + tau * matvec(L, x))

    x = Y
    it = 0
    diff = torch.tensor(float('inf'), dtype=Y.dtype, device=Y.device)
    while it < maxit and bool(diff > tol):
        x_new = _proj_simplex(x - step * grad(x))
        diff = torch.max(torch.abs(x_new - x))
        x = x_new
        it += 1
    return x
