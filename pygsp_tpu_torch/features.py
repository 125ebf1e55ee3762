"""Feature extraction (counterpart of :mod:`pygsp_tpu.features`).

The spectrogram filters the identity through one bank of M shifted
kernels in one Chebyshev recurrence, as the JAX package does: on the card
the CSR SpMM kernel at N columns and kernel B's grouped accumulation in
passes of four filters.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsp_tpu_torch import filters as _filters
from pygsp_tpu_torch import utils


def compute_avg_adj_deg(G):
    """Per vertex, the number of vertices reachable in two steps over its
    degree plus one (host SciPy). The product is boolean, as in the JAX
    package (and the reference): it counts the vertices, not the paths.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs, features
    >>> G = graphs.Ring(8, device='cpu')
    >>> features.compute_avg_adj_deg(G)
    array([1., 1., 1., 1., 1., 1., 1., 1.])
    """
    A = G.W > 0
    reach2 = ((A @ A) > 0)
    return np.asarray(reach2.sum(axis=1)).ravel().astype(float) / \
        (np.asarray(A.sum(axis=1)).ravel() + 1.0)


@utils.filterbank_handler
def compute_tig(g, i=0, **kwargs):
    """The frame of one kernel of the bank, ``g_i(L)`` as an (N, N) matrix
    (:meth:`Filter.compute_frame`); the list over the bank's kernels
    without ``i``.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters, features
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Heat(G, scale=[5, 20])
    >>> [tuple(t.shape) for t in features.compute_tig(g)]
    [(64, 64), (64, 64)]
    """
    return _filters.Filter(g.G, g._kernels[i]).compute_frame(**kwargs)


@utils.filterbank_handler
def compute_norm_tig(g, i=0, **kwargs):
    """The ℓ2 norm of each row of :func:`compute_tig`: (N,) per kernel."""
    tig = compute_tig(g, i=i, **kwargs)
    return torch.linalg.norm(tig.reshape(g.G.N, -1), dim=1)


def compute_spectrogram(G, atom=None, M=100, **kwargs):
    """Graph spectrogram: each vertex's energy under M kernels shifted
    across the spectrum, ``atom(λ − s)`` for s in ``linspace(0, λmax,
    M)`` (default atom ``exp(−M (λ/λmax)²)``), from one M-filter bank
    applied to the identity (``kwargs`` go to :meth:`Filter.filter`).
    Returns the (N, M) host array and sets ``G.spectr``.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, features
    >>> G = graphs.Sensor(32, seed=42, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> features.compute_spectrogram(G, M=5).shape
    (32, 5)
    """
    if atom is None:
        def atom(x):
            return torch.exp(-M * (x / G.lmax) ** 2)

    scale = np.linspace(0, G.lmax, M)
    kernels = [lambda x, s=float(s): atom(x - s) for s in scale]
    bank = _filters.Filter(G, kernels)

    # all N deltas through all M kernels at once:
    # out[:, n, m] = g_m(L) δ_n, its norm over the first axis
    s = torch.eye(G.N, dtype=G.dtype, device=G.device)
    out = bank.filter(s, **kwargs)            # (N, N, M)
    spectr = torch.linalg.norm(out, dim=0) ** 2  # (N, M)
    G.spectr = spectr.cpu().numpy()
    return G.spectr
