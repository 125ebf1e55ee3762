"""Simple tight frame."""

from __future__ import annotations

import math

import numpy as np
import torch

from pygsp_tpu_torch.filters.filter import Filter, _ftype


def _stf_kernel(x, kind):
    """'sf' supported on [0, 1/2]; 'wavelet' on [1/4, 1]."""
    x = torch.as_tensor(x)
    l1, l2, l3 = 0.25, 0.5, 1.0

    def h(v):
        return torch.sin(math.pi * v / 2.0) ** 2

    r1 = x < l1
    r2 = (x >= l1) & (x < l2)
    r3 = (x >= l2) & (x < l3)
    if kind == 'sf':
        out = r1.to(_ftype(x))
        return torch.where(
            r2, torch.sqrt(torch.clamp(1 - h(4 * x - 1) ** 2, min=0.0)), out)
    if kind == 'wavelet':
        out = torch.where(r2, h(4 * (x - 0.25)), 0.0)
        return torch.where(
            r3, torch.sqrt(torch.clamp(1 - h(2 * x - 1) ** 2, min=0.0)), out)
    raise ValueError(f'Unknown kernel type {kind}')


class SimpleTight(Filter):
    r"""sin²/cos² tight pair at the dyadic scales ``1/(2·lmax)·2^i``.

    Examples
    --------
    >>> import torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.SimpleTight(G, Nf=4)
    >>> g.Nf
    4
    >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
    >>> v = (g.evaluate(lam) ** 2).sum(dim=0)
    >>> print(round(float(v.max() / v.min()), 2))   # tight: constant frame
    1.0
    """

    def __init__(self, G, Nf=6, scales=None):
        if scales is None or (np.ndim(scales) == 0 and not scales):
            scales = 1.0 / (2.0 * G.lmax) * np.power(2, np.arange(Nf - 2, -1, -1))
        self.scales = np.asarray(scales)
        if len(self.scales) != Nf - 1:
            raise ValueError('len(scales) should be Nf-1.')

        kernels = [lambda x: _stf_kernel(float(self.scales[0]) * x, 'sf')]
        for i in range(Nf - 1):
            kernels.append(lambda x, i=i: _stf_kernel(
                float(self.scales[i]) * x, 'wavelet'))
        super().__init__(G, kernels)
