"""Mexican-hat wavelet bank."""

from __future__ import annotations

import math

import numpy as np
import torch

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.filters.filter import Filter


class MexicanHat(Filter):
    r"""Band-pass ``x·e^{-x}`` at log scales plus the low-pass ``e^{-x⁴}``.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.MexicanHat(G, Nf=5)
    >>> g.Nf
    5
    >>> y = g.evaluate(torch.linspace(0, G.lmax, 8, dtype=torch.float64))
    >>> tuple(y.shape)              # one row per wavelet scale
    (5, 8)
    >>> bool(torch.isfinite(y).all())
    True
    >>> s = np.zeros(G.N); s[11] = 1.0
    >>> tuple(g.filter(s, order=30).shape)
    (64, 5)
    """

    def __init__(self, G, Nf=6, lpfactor=20, scales=None, normalize=False):
        self.lpfactor = lpfactor
        self.normalize = normalize

        lmin = G.lmax / lpfactor
        if scales is None:
            scales = utils.compute_log_scales(lmin, G.lmax, Nf - 1)
        self.scales = np.asarray(scales)
        if len(self.scales) != Nf - 1:
            raise ValueError('len(scales) should be Nf-1.')

        def band_pass(x):
            return x * torch.exp(-x)

        def low_pass(x):
            return torch.exp(-(x ** 4))

        kernels = [lambda x: 1.2 * math.exp(-1) * low_pass(x / 0.4 / lmin)]
        for i in range(Nf - 1):
            def kernel(x, i=i):
                scale = float(self.scales[i])
                norm = math.sqrt(scale) if normalize else 1.0
                return norm * band_pass(scale * x)
            kernels.append(kernel)
        super().__init__(G, kernels)

    def _get_extra_repr(self):
        return dict(lpfactor=f'{self.lpfactor:.2f}', normalize=self.normalize)
