"""Blocked Lanczos recursion, and Lanczos filtering.

Counterpart of :mod:`pygsp_tpu.ops.lanczos`: one Krylov recursion advances
every column of an (N, S) block at once, each step one SpMM (a kernel on
the card) plus per-column reductions, followed by a small batched ``eigh``
of the tridiagonal H matrices. On a windowed operator, or a chunked one
built with ``permute='degree'``, the whole recursion runs in the matrix's
internal (relabeled) order (``LaplacianOp.hoisted``):
dot products and norms do not see the permutation, so the permutes apply
once per solve.

The reductions over the basis (the reorthogonalization and the filter's
assembly) run one basis vector at a time, where the JAX package's einsums
would lay out the (order, N, S) basis again: the same sums, without a
second copy of the basis at bench width.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core.operators import LaplacianOp, matvec
from pygsp_tpu_torch.ops.chebyshev import _promote


def _dots(V, r, k: int):
    """``(k, S)``: the per-column dot products of ``V[0..k-1]`` with
    ``r`` (N, S)."""
    return torch.stack([(V[j] * r).sum(dim=0) for j in range(k)])


def _combine(V, w):
    """``Σ_o V[o] · w[o]`` for ``V (o, N, S)`` and ``w (o, S)``."""
    out = V[0] * w[0]
    for j in range(1, w.shape[0]):
        out.addcmul_(V[j], w[j])
    return out


def _lanczos_block(mv, x: torch.Tensor, order: int):
    """Blocked Lanczos bases for every column of ``x`` (N, S) at once.

    Returns ``V``: (order, N, S) and ``H``: (S, order, order). Full
    reorthogonalization each step, against the basis vectors so far (the
    later ones are still zero). A breakdown (zero residual) zeroes the
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
        r = r - _combine(V, _dots(V, r, k + 1))
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


def _hoisted(L: LaplacianOp, x: torch.Tensor):
    """``(mv, x, pout)``: the matvec of ``L`` in its internal order, ``x``
    promoted with the operator and permuted into that order, and the
    permute out of it."""
    L, x = _promote(L, x)
    op, pin, pout = L.hoisted()
    return (lambda v: matvec(op, v)), pin(x), pout


def _lanczos_single(L: LaplacianOp, x: torch.Tensor, order: int):
    """Lanczos basis for one vector: returns V (N, order), H (order, order)."""
    mv, xp, pout = _hoisted(L, x)
    V, H = _lanczos_block(mv, xp[:, None], order)
    return pout(torch.movedim(V[:, :, 0], 0, 1)), H[0]


def lanczos_basis(L: LaplacianOp, x: torch.Tensor, order: int):
    """Per-column Lanczos bases. x: (N,) or (N, S) →
    V: (S, N, order), H: (S, order, order) (S squeezed off for 1-D x)."""
    if x.ndim == 1:
        return _lanczos_single(L, x, order)
    mv, xp, pout = _hoisted(L, x)
    V, H = _lanczos_block(mv, xp, order)
    return pout(V.permute(2, 1, 0), axis=1), H


def _ritz(H, evaluate):
    """``(uh, fe)``: the Ritz vectors of each column's H, (S, order,
    order), and the bank's responses at its Ritz values clamped at 0,
    (Nf, S, order)."""
    eh, uh = torch.linalg.eigh(H)                       # (S, o), (S, o, o)
    eh = eh.clamp(min=0.0)
    fe = torch.atleast_2d(evaluate(eh.reshape(-1)))     # (Nf, S*o)
    return uh, fe.reshape(fe.shape[0], *eh.shape)


def lanczos_op(L: LaplacianOp, evaluate, x: torch.Tensor,
               order: int = 30) -> torch.Tensor:
    """Filter ``x`` through a bank via the Lanczos approximation.

    ``evaluate``: λ-tensor → (Nf, len(λ)) kernel responses.
    x: (N,) or (N, S). Returns (Nf, N) or (Nf, N, S), the layout of
    :func:`~pygsp_tpu_torch.ops.chebyshev.cheby_op`: per column,
    ``‖x‖ V U f(Θ) Uᵀ e₁`` with the Ritz pairs (Θ, U) of its H.
    """
    squeeze = x.ndim == 1
    xs = x[:, None] if squeeze else x
    mv, xp, pout = _hoisted(L, xs)
    V, H = _lanczos_block(mv, xp, order)                # (o, N, S)
    uh, fe = _ritz(H, evaluate)                         # (S, o, o), (Nf, S, o)
    # the JAX package's VU = V uh and proj = VUᵀ x, by the basis
    proj = torch.einsum('soj,os->sj', uh, _dots(V, xp, order))
    w = torch.einsum('soj,fsj->fos', uh, fe * proj[None])   # (Nf, o, S)
    out = torch.stack([_combine(V, w[f]) for f in range(w.shape[0])])
    out = pout(out, axis=1)
    return out[..., 0] if squeeze else out


def lanczos_synthesis_op(L: LaplacianOp, evaluate, s: torch.Tensor,
                         order: int = 30) -> torch.Tensor:
    """Synthesis ``Σ_i g_i(L) s[..., i]`` in one blocked pass: the Krylov
    recursions of all (signal, filter) columns advance together, each step
    one (N, S·Nf)-wide SpMM.

    ``evaluate``: λ-tensor → (Nf, len(λ)) bank responses.
    s: (N, S, Nf). Returns (N, S).
    """
    n, n_s, nf = s.shape
    cols = s.reshape(n, n_s * nf)                   # filter-major flatten
    mv, xp, pout = _hoisted(L, cols)
    V, H = _lanczos_block(mv, xp, order)
    uh, fe_all = _ritz(H, evaluate)                 # (C, o, o), (Nf, C, o)
    c = torch.arange(n_s * nf, device=xp.device)
    fe = fe_all[c % nf, c]                          # each column's kernel
    proj = torch.einsum('coj,oc->cj', uh, _dots(V, xp, order))
    out = _combine(V, torch.einsum('coj,cj->oc', uh, fe * proj))
    return pout(out).reshape(n, n_s, nf).sum(dim=2)
