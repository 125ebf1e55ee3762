"""Ideal band indicator filter."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.filters.filter import Filter, _ftype


class Rectangular(Filter):
    r"""Indicator of ``band_min ≤ x/lmax ≤ band_max``.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Rectangular(G, band_max=0.3)
    >>> lam = torch.tensor([0.1, 0.9], dtype=torch.float64) * G.lmax
    >>> g.evaluate(lam).tolist()      # exact indicator of the band
    [[1.0, 0.0]]
    """

    def __init__(self, G, band_min=None, band_max=0.2):
        self.band_min = band_min
        self.band_max = band_max

        def kernel_lowpass(x):
            return (x / G.lmax <= band_max).to(_ftype(x))

        def kernel_highpass(x):
            return (x / G.lmax >= band_min).to(_ftype(x))

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
        return attrs
