"""Spectrum estimation: the Lanczos λmax estimate, the algebraic bounds and
the dense Fourier basis.

Counterpart of :mod:`pygsp_tpu.ops.eigen` without its LOBPCG path. The
Lanczos start vector comes from a seeded ``torch.Generator`` on the
operator's device; it cannot match ``jax.random``, so parity tests pin
λmax.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core.operators import (LaplacianOp, degrees_from_adjacency,
                                            matvec)
from pygsp_tpu_torch.ops.lanczos import _lanczos_single
from pygsp_tpu_torch.ops.spmm import spmm


def estimate_lmax_lanczos(L: LaplacianOp, order: int = 32,
                          seed: int = 42, inflation: float = 1.01):
    """Largest-eigenvalue estimate via fixed-order Lanczos, ×1.01.

    Deterministic for a given device: the start vector is drawn from a
    ``torch.Generator`` seeded with ``seed``. Returns a 0-d tensor.
    """
    n = L.n_vertices
    order = min(order, n)
    gen = torch.Generator(device=L.device).manual_seed(seed)
    v0 = torch.randn(n, generator=gen, dtype=L.dtype, device=L.device)
    if order == 1:
        v0 = v0 / torch.linalg.norm(v0)
        return (v0 @ matvec(L, v0)) * inflation
    _, H = _lanczos_single(L, v0, order)
    return torch.max(torch.linalg.eigvalsh(H)) * inflation


def estimate_lmax_bounds(W, dw=None, lap_type: str = 'combinatorial'):
    """Algebraic upper bound on λmax (min of four classical bounds).

    ``W`` is a symmetric adjacency :class:`CSRMatrix`.
    """
    if lap_type == 'normalized':
        return torch.tensor(2.0, dtype=W.dtype, device=W.device)
    if lap_type != 'combinatorial':
        raise ValueError(f'Unknown Laplacian type {lap_type!r}')
    if dw is None:
        _, dw = degrees_from_adjacency(W)
    n = W.n_rows
    nnz = W.nnz
    vals = W.vals[:nnz]
    b_full = n * torch.max(vals)
    b_gersh = 2.0 * torch.max(dw)
    # Anderson–Morley: max over edges of dw[i] + dw[j]
    b_am = torch.max(dw[W.rows[:nnz].long()] + dw[W.cols[:nnz].long()])
    # Merris: max dw[i] + mean degree of neighbors
    wdw = matvec_adj(W, dw)
    safe_dw = torch.where(dw > 0, dw, torch.ones_like(dw))
    b_merris = torch.max(dw + wdw / safe_dw)
    return torch.minimum(torch.minimum(b_full, b_gersh),
                         torch.minimum(b_am, b_merris))


def matvec_adj(W, x):
    """Adjacency matvec (no diag term)."""
    return spmm(W, x)


def fourier_basis(L: LaplacianOp, n_eigenvectors: int | None = None):
    """Eigendecomposition of the Laplacian: ``(e, U)``, ascending, with
    ``e[0]`` set to exactly 0 as in the reference. The dense operator goes
    to ``torch.linalg.eigh`` on its device. A partial request that the JAX
    package sends to LOBPCG (``k < N``, ``N > 2000`` and ``5k < N``) raises
    ``NotImplementedError``: LOBPCG is not ported yet."""
    n = L.n_vertices
    k = n if n_eigenvectors is None else int(n_eigenvectors)
    if k < n and n > 2000 and 5 * k < n:
        raise NotImplementedError(
            f'fourier_basis(n_eigenvectors={k}) on {n} vertices takes the '
            f'LOBPCG path (partial_fourier_basis), which is not ported yet: '
            f'see ROADMAP.md, "Modules to port", item 2 (the rest of the '
            f'spectral side)')
    e, U = torch.linalg.eigh(L.to_dense())
    e[0] = 0.0
    if k < e.shape[0]:
        e, U = e[:k], U[:, :k]
    return e, U
