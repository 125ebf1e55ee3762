"""Smooth exponential-window band filter."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Expwin(Filter):
    r"""C∞ band filter from the bump-function partition ``h = e/(e + ẽ)``.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Expwin(G, band_max=0.25)
    >>> g.Nf
    1
    >>> lam = torch.tensor([0.0, G.lmax], dtype=torch.float64)
    >>> [[round(v, 1) for v in row] for row in g.evaluate(lam).tolist()]
    [[0.9, 0.0]]
    """

    def __init__(self, G, band_min=None, band_max=0.2, slope=1):
        self.band_min = band_min
        self.band_max = band_max
        self.slope = slope

        def bump(x):
            # e^{-slope/x} for x > 0, exactly 0 for x <= 0, overflow-safe
            safe = torch.where(x <= 0, 1.0, x)
            return torch.where(x <= 0, 0.0, torch.exp(-slope / safe))

        def h(x):
            y = bump(x)
            z = bump(1 - x)
            return y / (y + z)

        def kernel_lowpass(x):
            return h(0.5 - x / G.lmax + band_max)

        def kernel_highpass(x):
            return h(0.5 + x / G.lmax - band_min)

        if band_min is None and band_max is None:
            kernel = torch.ones_like
        elif band_min is None:
            kernel = kernel_lowpass
        elif band_max is None:
            kernel = kernel_highpass
        else:
            def kernel(x):
                return kernel_lowpass(x) * kernel_highpass(x)
        super().__init__(G, kernel)

    def _get_extra_repr(self):
        attrs = dict()
        if self.band_min is not None:
            attrs.update(band_min=f'{self.band_min:.2f}')
        if self.band_max is not None:
            attrs.update(band_max=f'{self.band_max:.2f}')
        attrs.update(slope=f'{self.slope:.0f}')
        return attrs
