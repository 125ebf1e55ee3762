"""Itersine tight frame."""

from __future__ import annotations

import math

import numpy as np
import torch

from pygsp_tpu_torch.filters.filter import Filter


class Itersine(Filter):
    r"""Tight frame of ``sin(½π·cos²(πx))`` translates with overlap 2.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Itersine(G, Nf=5)
    >>> g.Nf
    5
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(round(float(v.max() / v.min()), 2))   # tight: constant frame
    1.0
    """

    def __init__(self, G, Nf=6, overlap=2):
        self.overlap = overlap
        self.mu = np.linspace(0, G.lmax, num=Nf)
        scales = G.lmax / (Nf - overlap + 1) * overlap

        def window(x):
            y = torch.sin(0.5 * math.pi * torch.cos(x * math.pi) ** 2)
            return y * ((x >= -0.5) & (x <= 0.5))

        kernels = []
        for i in range(1, Nf + 1):
            def kernel(x, i=i):
                y = window(x / scales - (i - overlap / 2) / overlap)
                return y * math.sqrt(2 / overlap)
            kernels.append(kernel)
        super().__init__(G, kernels)

    def _get_extra_repr(self):
        return dict(overlap=f'{self.overlap:.2f}')
