"""Blocked Lanczos recursion (the part λmax estimation needs).

Counterpart of :mod:`pygsp_tpu.ops.lanczos`: one Krylov recursion advances
every column of an (N, S) block at once, each step one SpMM plus
per-column reductions. On a windowed operator the whole recursion runs in
the matrix's internal (relabeled) order (``LaplacianOp.hoisted``): dot
products and norms do not see the permutation, so the permutes apply once
per solve. Lanczos filtering (``lanczos_op``) is not ported yet.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core.operators import LaplacianOp, matvec


def _lanczos_block(mv, x: torch.Tensor, order: int):
    """Blocked Lanczos bases for every column of ``x`` (N, S) at once.

    Returns ``V``: (order, N, S) and ``H``: (S, order, order). Full
    reorthogonalization each step. A breakdown (zero residual) zeroes the
    later basis vectors of that column instead of stopping early.
    """
    n, s = x.shape
    dtype = x.dtype
    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps

    norm_x = torch.linalg.norm(x, dim=0)                      # (S,)
    q = x / norm_x.clamp(min=tiny)

    V = torch.zeros((order, n, s), dtype=dtype, device=x.device)
    V[0] = q
    r = mv(q)
    alpha0 = torch.sum(q * r, dim=0)                          # (S,)
    r = r - alpha0 * q

    alphas = torch.zeros((order, s), dtype=dtype, device=x.device)
    alphas[0] = alpha0
    betas = torch.zeros((order, s), dtype=dtype, device=x.device)

    for k in range(1, order):
        beta = torch.linalg.norm(r, dim=0)
        alive = beta > 10 * eps
        q_new = torch.where(alive, r / beta.clamp(min=tiny),
                            torch.zeros_like(r))
        V[k] = q_new
        r = mv(q_new) - beta * q
        alpha = torch.sum(q_new * r, dim=0)
        r = r - alpha * q_new
        # full reorthogonalization (per column)
        r = r - torch.einsum('kns,ks->ns', V, torch.einsum('kns,ns->ks', V, r))
        alphas[k] = alpha
        betas[k] = torch.where(alive, beta, torch.zeros_like(beta))
        q = q_new

    # H per column: batched tridiagonal from (order, S) alphas/betas
    ii = torch.arange(order, device=x.device)
    H = torch.zeros((s, order, order), dtype=dtype, device=x.device)
    H[:, ii[:-1], ii[1:]] = betas.T[:, 1:]
    H[:, ii[1:], ii[:-1]] = betas.T[:, 1:]
    H = H + alphas.T[:, :, None] * torch.eye(order, dtype=dtype,
                                             device=x.device)[None]
    return V, H


def _lanczos_single(L: LaplacianOp, x: torch.Tensor, order: int):
    """Lanczos basis for one vector: returns V (N, order), H (order, order)."""
    op, pin, pout = L.hoisted()
    V, H = _lanczos_block(lambda v: matvec(op, v), pin(x)[:, None], order)
    return pout(torch.movedim(V[:, :, 0], 0, 1)), H[0]
