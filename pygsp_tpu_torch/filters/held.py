"""Held quadrature-mirror pair."""

from __future__ import annotations

import math

import torch

from pygsp_tpu_torch.filters.filter import Filter, _ftype


class Held(Filter):
    r"""Low/high pair: 1 on [0, a), a sine-of-cubic transition on [a, 2a).

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Held(G)
    >>> g.Nf                             # low-pass + exact complement
    2
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(np.round(v.numpy(), 2))    # exact quadrature-mirror pair
    [1. 1. 1. 1. 1.]
    """

    def __init__(self, G, a=2.0 / 3):
        self.a = a

        def mu(t):
            return -1 + 24 * t - 144 * t ** 2 + 256 * t ** 3

        def kernel(x):
            x = x * 2 / G.lmax
            trans = torch.sin(2 * math.pi * mu(x / (8 * a)))
            out = ((x >= 0) & (x < a)).to(_ftype(x))
            return torch.where((x >= a) & (x < 2 * a), trans, out)

        low = Filter(G, kernel)
        complement = low.complement(frame_bound=1)
        super().__init__(G, low._kernels + complement._kernels)

    def _get_extra_repr(self):
        return dict(a=f'{self.a:.2f}')
