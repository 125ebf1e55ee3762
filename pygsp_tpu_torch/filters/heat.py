"""Heat (low-pass exponential) kernel filter bank."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Heat(Filter):
    r"""Heat diffusion kernel: ``g(x) = min(exp(-scale·x/lmax), 1)``.

    One kernel per scale, default scale 10; ``normalize=True`` divides each
    by ``‖g(G.e)‖``, which needs the Fourier basis.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(6, 6, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Heat(G, scale=[10, 100])
    >>> g.Nf
    2
    >>> s = np.zeros(G.N); s[7] = 1.0
    >>> out = g.filter(s, order=30)
    >>> [round(v, 2) for v in out.sum(dim=0).tolist()]  # diffusion conserves mass
    [1.0, 1.0]
    """

    def __init__(self, G, scale=10, normalize: bool = False):
        try:
            iter(scale)
        except TypeError:
            scale = [scale]
        self.scale = list(scale)
        self.normalize = normalize

        # G.lmax is read at evaluation time (not captured) so the kernels
        # track lmax refinements.
        def base(x, s):
            return torch.clamp(torch.exp(-s * x / G.lmax), max=1.0)

        kernels = []
        for s in self.scale:
            norm = float(torch.linalg.norm(base(G.e, s))) if normalize else 1.0
            kernels.append(lambda x, s=s, norm=norm: base(x, s) / norm)
        super().__init__(G, kernels)

    def _get_extra_repr(self):
        scale = '[' + ', '.join(f'{s:.2f}' for s in self.scale) + ']'
        return dict(scale=scale, normalize=self.normalize)
