"""Modulation (windowed graph Fourier transform) filter bank; exact
filtering only."""

from __future__ import annotations

import math

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Modulation(Filter):
    r"""A kernel modulated by each eigenvector: the vertex-frequency
    (windowed GFT) analysis operator. ``evaluate`` is defined at the graph's
    eigenvalues only: it looks each λ up in ``G.e`` exactly and gives NaN
    elsewhere.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(4, 4, device='cpu', dtype=torch.float64)
    >>> G.compute_fourier_basis()
    >>> mother = filters.Heat(G, scale=20)
    >>> g = filters.Modulation(G, mother)
    >>> g.Nf == G.N              # one modulated kernel per vertex frequency
    True
    >>> s = np.zeros(G.N); s[2] = 1.0
    >>> tuple(g.filter(s, method='exact').shape)
    (16, 16)
    """

    def __init__(self, graph, kernel, modulation_first: bool = False):
        self.G = graph
        self._kernels = kernel
        self._modulation_first = modulation_first

        if kernel.n_filters != 1:
            raise ValueError(f'A kernel must be one filter. The passed '
                             f'filter bank {kernel} has {kernel.n_filters}.')
        if kernel.G is not graph:
            raise ValueError('The graph passed to this filter bank must '
                             'be the one used to build the mother kernel.')

        self.n_features_in, self.n_features_out = (1, graph.n_vertices)
        self.shape = (self.n_features_out, self.n_features_in)
        self.n_filters = self.n_features_in * self.n_features_out
        self.Nf = self.n_filters

    def _coefficients_matrix(self):
        if not hasattr(self, '_coefficients'):
            G = self.G
            c = G.igft(self._kernels.evaluate(G.e).squeeze())
            c = math.sqrt(G.n_vertices) * G.U * c[:, None]
            self._coefficients = G.gft(c)
        return self._coefficients

    def evaluate(self, x):
        """Responses at the graph's frequencies only, NaN elsewhere: each
        value of x is looked up in ``G.e`` by equality (one comparison
        matrix)."""
        coeff = self._coefficients_matrix()          # (N_out, N_e)
        e = self.G.e
        x = torch.as_tensor(x, device=e.device)
        match = x.reshape(-1)[:, None] == e[None, :]  # (len(x), N_e)
        any_match = torch.any(match, dim=1)
        idx = torch.argmax(match.to(torch.uint8), dim=1)   # the first match
        y = torch.where(any_match[None, :], coeff[:, idx], torch.nan)
        return y.reshape((self.n_features_out,) + tuple(x.shape))

    def filter(self, s, method='exact', order=None):
        if self._modulation_first:
            return super().filter(s, method='exact')
        # localization then modulation: y[i] = √N · GFT(s ⊙ localize(i)),
        # all N vertices at once as one N×N batch
        G = self.G
        U = G.U
        s = torch.as_tensor(G._check_signal(s), device=U.device)
        dt = torch.promote_types(s.dtype, U.dtype)
        s, U = s.to(dt), U.to(dt)
        ker = self._kernels.evaluate(G.e)[0].to(dt)              # (N_e,)
        gL = U @ (ker[:, None] * U.T)                            # g(L)
        loc = math.sqrt(G.n_vertices) * gL.T                     # g(L)δ_i
        prod = s[None, :] * loc                                  # (N, N)
        return prod @ U.conj() * math.sqrt(G.n_vertices)
