"""Spectrum estimation: the Lanczos λmax estimate, the algebraic bounds,
power iteration, and the dense and the partial (LOBPCG) Fourier basis.

Counterpart of :mod:`pygsp_tpu.ops.eigen`. The random start vectors come
from seeded ``torch.Generator``s on the operator's device; they cannot match
``jax.random``, so parity tests pin λmax and hold LOBPCG's eigenpairs to a
tolerance.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch.core.operators import (LaplacianOp, degrees_from_adjacency,
                                            matvec)
from pygsp_tpu_torch.core.chunked import ChunkedELLMatrix
from pygsp_tpu_torch.core.sparse import BandedMatrix, CSRMatrix, ELLMatrix
from pygsp_tpu_torch.ops.lanczos import _lanczos_single
from pygsp_tpu_torch.ops.lobpcg import lobpcg_standard
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
    """(Partial) eigendecomposition of the Laplacian: ``(e, U)``, ascending,
    with ``e[0]`` set to exactly 0 as in the reference. A full request
    densifies the operator and runs ``torch.linalg.eigh`` on its device; a
    partial one with k small against N (``k < N``, ``N > 2000`` and
    ``5k < N``) goes to LOBPCG (:func:`partial_fourier_basis`)."""
    n = L.n_vertices
    k = n if n_eigenvectors is None else int(n_eigenvectors)
    if k < n and n > 2000 and 5 * k < n:
        return partial_fourier_basis(L, k)
    e, U = torch.linalg.eigh(L.to_dense())
    e[0] = 0.0
    if k < e.shape[0]:
        e, U = e[:k], U[:, :k]
    return e, U


def laplacian_upper_bound(L: LaplacianOp):
    """Gershgorin's bound on λmax, ``max_i (diag_i + Σ_j |offdiag_ij|)``, as
    a 0-d tensor. On the CSR and chunked formats the row sums are one SpMM
    of ``|vals|`` by a vector of ones; on the ELL format the sums of level
    0's rows plus those of each level, added onto its unique rows; on the
    banded format sums over the tiles. The windowed format raises
    ``TypeError`` (the JAX package has no path for it either)."""
    off = L.offdiag
    if isinstance(off, CSRMatrix):
        ones = torch.ones(off.n_cols, dtype=off.dtype, device=off.device)
        absrow = spmm(off.with_vals(torch.abs(off.vals)), ones)
    elif isinstance(off, ChunkedELLMatrix):
        ones = torch.ones(off.n_cols, dtype=off.dtype, device=off.device)
        absrow = spmm(off.abs_vals(), ones)
    elif isinstance(off, ELLMatrix):
        absrow = torch.sum(torch.abs(off.ell_vals), dim=1)[:off.n_rows]
        for lev in off.levels:
            absrow = absrow.index_add(0, lev.rows.long(),
                                      torch.sum(torch.abs(lev.vals), dim=1))
    elif isinstance(off, BandedMatrix):
        absrow = torch.sum(torch.abs(off.tiles),
                           dim=(1, 3)).reshape(-1)[:off.n_rows]
    else:
        raise TypeError(f'laplacian_upper_bound takes a Laplacian on the CSR, '
                        f'ELL, banded or chunked format, not '
                        f'{type(off).__name__}')
    return torch.max(L.diag + absrow)


def partial_fourier_basis(L: LaplacianOp, k: int, *, maxiter: int = 3000,
                          tol=None, seed: int = 17):
    """The k smallest eigenpairs of L by LOBPCG on the flipped operator
    ``B = c·I − L``, ``c = 1.01 ×`` :func:`laplacian_upper_bound`: L's
    smallest eigenvalues are B's largest, ``λ = c − θ``. Each iteration is
    a few k-wide SpMMs of L. Returns ``(e, U)``, ascending, ``e[0] = 0``;
    the start block is drawn from a ``torch.Generator`` seeded with
    ``seed``.

    The iteration ends when every pair has converged (``tol``, as in
    :func:`~pygsp_tpu_torch.ops.lobpcg.lobpcg_standard`) or after
    ``maxiter`` iterations. The JAX package stops at 300, which is short of
    convergence once the small eigenvalues crowd: in float64 ``Grid2d(100,
    27)`` needs 612 iterations at k = 4 and a 16384-vertex ``Sensor`` graph
    1356 at k = 3, where 300 leave its eigenvalues 7e-3 and 7e-2 off.

    A float32 operator is solved as a float64 copy on its device, and
    ``(e, U)`` cast back to float32: LOBPCG's stopping rule (a residual
    under eps · 10 · n of the eigenvalue's scale) holds at the first
    iteration in float32 once n is a few thousand, and the JAX package,
    which keeps float32, returns eigenpairs far off there.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Grid2d(60, 7, device='cpu', dtype=torch.float64)
    >>> e, U = partial_fourier_basis(G.L, 3)
    >>> float(e[0]), tuple(U.shape)
    (0.0, (420, 3))
    """
    n = L.n_vertices
    if not 1 <= k or 5 * k >= n:
        raise ValueError(f'need 1 <= k and 5k < n, got k={k}, n={n}')
    if L.dtype == torch.float32:
        e, U = partial_fourier_basis(L.astype(torch.float64), k,
                                     maxiter=maxiter, tol=tol, seed=seed)
        return e.float(), U.float()
    c = laplacian_upper_bound(L) * 1.01

    def B(x):
        return c * x - matvec(L, x)

    gen = torch.Generator(device=L.device).manual_seed(seed)
    x0 = torch.randn((n, k), generator=gen, dtype=L.dtype, device=L.device)
    theta, U, _ = lobpcg_standard(B, x0, m=maxiter, tol=tol)
    e = c - theta
    order = torch.argsort(e)
    e = e[order]
    e[0] = 0.0
    return e, U[:, order]


def power_iteration_lmax(L: LaplacianOp, iters: int = 100, seed: int = 0):
    """λmax by plain power iteration on L (slower to converge than Lanczos
    on clustered spectra), as a 0-d tensor; the start vector is drawn from
    a ``torch.Generator`` seeded with ``seed``."""
    n = L.n_vertices
    gen = torch.Generator(device=L.device).manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=L.dtype, device=L.device)
    v = v / torch.linalg.norm(v)
    tiny = torch.finfo(v.dtype).tiny
    for _ in range(iters):
        w = matvec(L, v)
        v = w / torch.clamp(torch.linalg.norm(w), min=tiny)
    return v @ matvec(L, v)
