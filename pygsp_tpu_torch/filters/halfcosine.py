"""Half-cosine tight frame."""

from __future__ import annotations

import math

import torch

from pygsp_tpu_torch.filters.filter import Filter


class HalfCosine(Filter):
    r"""Shifted raised-cosine translates (a tight frame).

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.HalfCosine(G, Nf=5)
    >>> g.Nf
    5
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(round(float(v.max() / v.min()), 2))   # tight: constant frame
    1.0
    """

    def __init__(self, G, Nf=6):
        if Nf <= 2:
            raise ValueError('The number of filters must be greater than 2.')
        dila_fact = G.lmax * 3 / (Nf - 2)

        def window(x):
            y = 0.5 + 0.5 * torch.cos(2 * math.pi * (x / dila_fact - 0.5))
            return y * (x >= 0) * (x <= dila_fact)

        kernels = [lambda x, i=i: window(x - dila_fact / 3 * (i - 2))
                   for i in range(Nf)]
        super().__init__(G, kernels)
