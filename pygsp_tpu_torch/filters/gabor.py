"""Gabor filter bank: one shifted kernel per graph frequency; exact filtering
only."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Gabor(Filter):
    r"""``g_i(x) = g(x − λ_i)`` for every graph frequency λ_i (Nf = N).

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(4, 4, device='cpu', dtype=torch.float64)
    >>> G.compute_fourier_basis()
    >>> mother = filters.Heat(G, scale=20)
    >>> g = filters.Gabor(G, mother)
    >>> g.Nf == G.N                  # one shifted kernel per frequency
    True
    >>> s = np.zeros(G.N); s[4] = 1.0
    >>> tuple(g.filter(s, method='exact').shape)
    (16, 16)
    """

    def __init__(self, graph, kernel):
        if kernel.n_filters != 1:
            raise ValueError(f'A kernel must be one filter. The passed '
                             f'filter bank {kernel} has {kernel.n_filters}.')
        if kernel.G is not graph:
            raise ValueError('The graph passed to this filter bank must '
                             'be the one used to build the mother kernel.')

        self._mother = kernel
        e = graph.e
        kernels = [lambda x, i=i: kernel.evaluate(x - e[i])[0]
                   for i in range(graph.n_vertices)]
        super().__init__(graph, kernels)

    def evaluate(self, x):
        """All N shifts in one broadcast evaluation: (N, *x.shape)."""
        e = self.G.e
        x = torch.as_tensor(x, device=e.device)
        shifted = x[None, ...] - e.reshape((-1,) + (1,) * x.ndim)
        return self._mother.evaluate(shifted)[0]

    def filter(self, s, method='exact', order=None):
        """Gabor banks filter exactly (the dense spectral path)."""
        return super().filter(s, method='exact')
