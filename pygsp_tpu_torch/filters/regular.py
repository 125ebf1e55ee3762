"""Regular quadrature-mirror pair."""

from __future__ import annotations

import math

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Regular(Filter):
    r"""Low/high pair with ``g_l² + g_h² = 1`` by iterated sine flattening.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Regular(G, degree=2)
    >>> g.Nf
    2
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(np.round(v.numpy(), 2))    # exact quadrature-mirror pair
    [1. 1. 1. 1. 1.]
    """

    def __init__(self, G, degree=3):
        self.degree = degree

        def kernel(x):
            x = x * 2 / G.lmax
            if degree == 0:
                return torch.sin(math.pi / 4 * x)
            output = torch.sin(math.pi * (x - 1) / 2)
            for _ in range(2, degree):
                output = torch.sin(math.pi * output / 2)
            return torch.sin(math.pi / 4 * (1 + output))

        low = Filter(G, kernel)
        complement = low.complement(frame_bound=1)
        super().__init__(G, low._kernels + complement._kernels)

    def _get_extra_repr(self):
        return dict(degree=self.degree)
