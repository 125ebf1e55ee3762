"""Free functions in the calling conventions of PyGSP's
``filters/approximations.py``, over the port's Chebyshev and Lanczos
engines (:mod:`pygsp_tpu_torch.ops.chebyshev`,
:mod:`pygsp_tpu_torch.ops.lanczos`). Signals and coefficients are moved to
the graph's device."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.ops import chebyshev as _cheby
from pygsp_tpu_torch.ops import lanczos as _lanczos


def compute_cheby_coeff(f, m: int = 30, N: int | None = None,
                        i: int | None = None):
    """Chebyshev coefficients of a filter bank, in the graph's dtype: (m+1,)
    for a single filter or an explicit ``i``, else one vector per kernel
    in a list.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(4, 4, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> c = compute_cheby_coeff(filters.Heat(G, scale=[1, 2]), m=10)
    >>> len(c), tuple(c[0].shape)
    (2, (11,))
    """
    c = _cheby.cheby_coeff(f.evaluate, f.G.lmax, m=m, grid_n=N,
                           dtype=f.G.dtype, device=f.G.device)
    if i is not None:
        return c[i]
    if f.n_filters == 1:
        return c[0]
    return [c[k] for k in range(f.n_filters)]


def cheby_op(G, c, signal, **kwargs):
    """Apply Chebyshev coefficients ``c`` (Nscales, m+1) to a signal, in the
    stacked layout: (N·Nscales,) or (N·Nscales, Nv)."""
    c = torch.atleast_2d(torch.as_tensor(c, device=G.device))
    signal = torch.as_tensor(signal, device=G.device)
    if c.shape[1] < 2:
        raise TypeError('The coefficients have an invalid shape')
    r = _cheby.cheby_op(G.L, G.lmax, c, signal)       # (Nscales, N, ...)
    return r.reshape((-1,) + tuple(signal.shape[1:]))


def cheby_rect(G, bounds, signal, **kwargs):
    """Ideal band-pass filtering between ``bounds`` (closed-form Chebyshev
    coefficients, ``order`` 30 unless given)."""
    order = kwargs.pop('order', 30)
    return _cheby.cheby_rect(G.L, G.lmax, bounds,
                             torch.as_tensor(signal, device=G.device),
                             order=order)


def compute_jackson_cheby_coeff(filter_bounds, delta_lambda, m):
    """The raw and Jackson-damped Chebyshev coefficients of an ideal
    band-pass, as float64 NumPy arrays (computed on the host)."""
    ch, jch = _cheby.jackson_cheby_coeff(filter_bounds, delta_lambda, m,
                                         dtype=torch.float64, device='cpu')
    return ch.numpy(), jch.numpy()


def lanczos(A, order, x):
    """Lanczos basis of a Laplacian operator per signal column: ``(V, H)``
    (:func:`~pygsp_tpu_torch.ops.lanczos.lanczos_basis`)."""
    return _lanczos.lanczos_basis(A, torch.as_tensor(x, device=A.device),
                                  order)


def lanczos_op(f, s, order: int = 30):
    """Lanczos filtering of ``s`` by the bank ``f``, in the stacked layout
    of :func:`cheby_op`."""
    s = torch.as_tensor(s, device=f.G.device)
    r = _lanczos.lanczos_op(f.G.L, f.evaluate, s, order=order)
    return r.reshape((-1,) + tuple(s.shape[1:]))
