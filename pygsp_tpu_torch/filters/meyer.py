"""Meyer wavelet and scaling-function bank."""

from __future__ import annotations

import math

import numpy as np
import torch

from pygsp_tpu_torch.filters.filter import Filter, _ftype


def _nu(x):
    return x ** 4 * (35 - 84 * x + 70 * x ** 2 - 20 * x ** 3)


def _meyer_kernel(x, kind):
    """Meyer windows: the scaling function on [0, 4/3], the wavelet on
    [2/3, 8/3]."""
    x = torch.abs(torch.as_tensor(x))
    l1, l2, l3 = 2 / 3.0, 4 / 3.0, 8 / 3.0
    r1 = x < l1
    r2 = (x >= l1) & (x < l2)
    r3 = (x >= l2) & (x < l3)
    if kind == 'scaling_function':
        out = r1.to(_ftype(x))
        return torch.where(r2, torch.cos((math.pi / 2) * _nu(x / l1 - 1)),
                           out)
    if kind == 'wavelet':
        out = torch.where(r2, torch.sin((math.pi / 2) * _nu(x / l1 - 1)),
                          0.0)
        return torch.where(r3, torch.cos((math.pi / 2) * _nu(x / l2 - 1)),
                           out)
    raise ValueError(f'Unknown kernel type {kind}')


class Meyer(Filter):
    r"""Tight Meyer frame at the dyadic scales ``(4/(3·lmax))·2^i``.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Meyer(G, Nf=4)
    >>> g.Nf
    4
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(round(float(v.max() / v.min()), 2))   # tight: constant frame
    1.0
    >>> s = np.zeros(G.N); s[5] = 1.0
    >>> tuple(g.filter(s, order=30).shape)
    (64, 4)
    """

    def __init__(self, G, Nf=6, scales=None):
        if scales is None:
            scales = (4.0 / (3 * G.lmax)) * np.power(2.0, np.arange(Nf - 2, -1, -1))
        self.scales = np.asarray(scales)
        if len(self.scales) != Nf - 1:
            raise ValueError('len(scales) should be Nf-1.')

        kernels = [lambda x: _meyer_kernel(float(self.scales[0]) * x,
                                           'scaling_function')]
        for i in range(Nf - 1):
            kernels.append(lambda x, i=i: _meyer_kernel(
                float(self.scales[i]) * x, 'wavelet'))
        super().__init__(G, kernels)
