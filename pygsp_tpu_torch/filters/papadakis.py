"""Papadakis quadrature-mirror pair."""

from __future__ import annotations

import math

import torch

from pygsp_tpu_torch.filters.filter import Filter, _ftype


class Papadakis(Filter):
    r"""Low/high pair: 1 on [0, a), ``√((1−sin(3πx/2a))/2)`` on [a, 5a/3).

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Papadakis(G)
    >>> g.Nf
    2
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(np.round(v.numpy(), 2))    # exact quadrature-mirror pair
    [1. 1. 1. 1. 1.]
    """

    def __init__(self, G, a=0.75):
        self.a = a

        def kernel(x):
            x = x * 2 / G.lmax
            trans = torch.sqrt(torch.clamp(
                (1 - torch.sin(3 * math.pi / (2 * a) * x)) / 2, min=0.0))
            out = ((x >= 0) & (x < a)).to(_ftype(x))
            return torch.where((x >= a) & (x < a * 5 / 3), trans, out)

        low = Filter(G, kernel)
        complement = low.complement(frame_bound=1)
        super().__init__(G, low._kernels + complement._kernels)

    def _get_extra_repr(self):
        return dict(a=f'{self.a:.2f}')
