"""LOBPCG for the top-k eigenpairs of a symmetric operator.

The port's own copy of JAX's ``jax.experimental.sparse.linalg
.lobpcg_standard`` (its algorithm, defaults and comments' reasoning), in
torch: the operator is a callable, so the large products are the port's
SpMM; the small Rayleigh–Ritz problems (3k × 3k) and the block
orthonormalizations (k × k Gram matrices) go to ``torch.linalg``. The loop
runs in Python and reads the count of converged pairs once per iteration.

The method keeps an orthonormal block of search directions X, P and R
(eigenvector estimates, differences and residuals) and solves the
operator projected onto their span each iteration. Soft locking is left
out on purpose; the basis is truncated instead where it loses rank.
"""

from __future__ import annotations

import torch


def lobpcg_standard(A, X: torch.Tensor, m: int = 100, tol=None):
    """The top-k eigenpairs of a symmetric operator.

    Parameters
    ----------
    A : callable ``(n, j) -> (n, j)``, the operator's action.
    X : (n, k) initial search directions, linearly independent (they are
        orthonormalized); ``0 < 5k < n``.
    m : the most iterations.
    tol : a pair ``(λ, v)`` has converged when ``|A v − λ v|`` is below
        ``tol · 10 · n · (λ + |A v|)``; the iteration stops early when all
        k have. Default: the machine epsilon of X's dtype.

    Returns
    -------
    theta : (k,) eigenvalues, largest first.
    U : (n, k) eigenvectors.
    i : the number of iterations run.

    Examples
    --------
    >>> import torch
    >>> A = torch.diag(torch.arange(1.0, 21.0, dtype=torch.float64))
    >>> X = torch.randn(20, 2, dtype=torch.float64,
    ...                 generator=torch.Generator().manual_seed(0))
    >>> theta, U, i = lobpcg_standard(lambda v: A @ v, X, m=50)
    >>> [round(float(t), 6) for t in theta]
    [20.0, 19.0]
    """
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = torch.finfo(X.dtype).eps

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])

    # X, the best eigenvector estimates; P, the search directions; R, the
    # residuals, kept orthonormal (columns of P and R may be 0 after a
    # truncation of the basis, never those of X)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i = converged = 0
    while i < m and converged < k:
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)

        # the projected eigenproblem
        theta, Q = _rayleigh_ritz_orth(A, XPR)

        # the eigenvector estimates
        B = Q[:, :k]
        B = B / torch.linalg.norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.norm(X, dim=0, keepdim=True)

        # the difference directions: Q's block [0; Q[k:, :k]] made
        # orthogonal to Q[:, :k] in the standard basis before the map by
        # XPR, so that, XPR being orthonormal, the new directions are too
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, 1.0, normP)

        # the new residuals, and convergence by self-consistency: the
        # residual against the floating-point error expected of computing
        # it for an ideal eigenvector
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.norm(R, dim=0)
        reltol = (torch.linalg.norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1

    return theta[0, :], X, i


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f'must have search dim > 0, got {k}')
    if k * 5 >= n:
        raise ValueError(f'expected search dim * 5 < matrix dim (got '
                         f'{k * 5}, {n})')
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f'A, X must have same dtypes (were '
                         f'{test_output.dtype}, {X.dtype})')
    if test_output.shape != (n, 1):
        raise ValueError(f'A must be ({n}, {n}) matrix A, got output '
                         f'{tuple(test_output.shape)}')


def _eigh_descending(A):
    """``eigh`` of the symmetric part of A (as ``jnp.linalg.eigh``
    symmetrizes its input), largest eigenvalue first."""
    w, V = torch.linalg.eigh((A + A.T) / 2)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """An orthonormal basis of X's span by SVQB: the eigenbasis of the
    (k, k) Gram matrix of X's normalized columns; directions whose
    eigenvalue is below eps times the largest are dropped (their columns
    zeroed), so a rank-deficient X gives trailing zero columns."""
    norms = torch.linalg.norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)

    inner = X.T @ X
    w, V = _eigh_descending(inner)

    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    # tau == 0: X was all zeros
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)

    # XᵀX = V diag(w) Vᵀ, so W = X V diag(w)^(-1/2) has WᵀW = I
    orthoX = X @ (V * sqrted[None, :])

    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _project_out(basis, U):
    """U's component in the orthogonal complement of ``basis``
    (orthonormal, zero columns allowed), with its nonzero columns
    orthonormal. Orthogonality to the basis comes first: columns that may
    have picked the basis back up are zeroed, so a lower rank than U's can
    come out."""
    # twice is enough (Kahan), each subtraction followed by an
    # orthonormalization
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)

    # end on a subtraction of the basis: near convergence the residuals are
    # about 0, and their orthonormalization can bring basis components back
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _orthonormalize(basis):
    # twice is enough, again
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S):
    """The eigenpairs of A projected onto the orthonormal S (zero columns
    allowed): ``(w, V)`` with ``SᵀAS V = V diag(w)``, V orthonormal,
    largest first."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X, m):
    """``m`` directions that extend the orthonormal X (n, k) to an
    orthonormal (n, k + m) basis, by a block Householder reflector
    (deterministic, and never overlapping X as a random block might)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)

    # u vᵀ added to Xupper keeps its row and column spaces and lifts its
    # singular values by 1
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)

    # H(w) = I − 2 w wᵀ with 2 w wᵀ = y (v diag(1+s)^-1 vᵀ) yᵀ maps X to
    # [−u vᵀ; 0], so H(w) [0; I; 0] is orthogonal to X; its first m columns
    # extend it. [0; I_m; 0] selects rows k .. k + m of w.
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * (w @ w[k:k + m].T)
    h[k:k + m] += torch.eye(m, dtype=X.dtype, device=X.device)
    return h
