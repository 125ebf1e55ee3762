"""Abspline cubic-spline wavelet bank."""

from __future__ import annotations

import numpy as np
import torch
from scipy import optimize

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.filters.filter import Filter, _ftype


def _abspline3(x, alpha, beta, t1, t2):
    """Cubic spline joining the rise x^alpha (x ≤ t1) to the decay x^-beta
    (x ≥ t2). The 4×4 system of the spline's coefficients is solved on the
    host (NumPy); the kernel is evaluated in torch."""
    M = np.array([[1, t1, t1 ** 2, t1 ** 3],
                  [1, t2, t2 ** 2, t2 ** 3],
                  [0, 1, 2 * t1, 3 * t1 ** 2],
                  [0, 1, 2 * t2, 3 * t2 ** 2]], dtype=float)
    v = np.array([1, 1,
                  t1 ** (-alpha) * alpha * t1 ** (alpha - 1),
                  -beta * t2 ** (-beta - 1) * t2 ** beta], dtype=float)
    a = [float(coef) for coef in np.linalg.solve(M, v)]

    x = torch.as_tensor(x)
    xs = torch.clamp(x, min=torch.finfo(_ftype(x)).tiny)  # no 0^-beta
    r1 = x <= t1
    r3 = x >= t2
    spline = a[0] + a[1] * x + a[2] * x ** 2 + a[3] * x ** 3
    out = torch.where(r1, xs ** alpha * t1 ** (-alpha), spline)
    return torch.where(r3, xs ** (-beta) * t2 ** beta, out)


class Abspline(Filter):
    r"""Spline band-pass wavelets at log scales plus a tuned exponential
    low-pass.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Abspline(G, Nf=4)
    >>> g.Nf
    4
    >>> y = g.evaluate(torch.linspace(0, G.lmax, 6, dtype=torch.float64))
    >>> tuple(y.shape)
    (4, 6)
    >>> s = np.zeros(G.N); s[9] = 1.0
    >>> tuple(g.filter(s, order=30).shape)
    (64, 4)
    """

    def __init__(self, G, Nf=6, lpfactor=20, scales=None):
        self.lpfactor = lpfactor
        lmin = G.lmax / lpfactor
        if scales is None:
            scales = utils.compute_log_scales(lmin, G.lmax, Nf - 1)
        self.scales = np.asarray(scales)

        def gb(x):
            return _abspline3(x, 2, 2, 1, 2)

        def gl(x):
            return torch.exp(-(x ** 4))

        # the band kernel's peak sets the low-pass gain: a bounded scalar
        # minimization of -gb on the host, in float64
        def peak(x):
            return float(_abspline3(torch.tensor(x, dtype=torch.float64),
                                    2, 2, 1, 2))

        xstar = optimize.minimize_scalar(lambda x: -peak(x), bounds=(1, 2),
                                         method='bounded')
        gamma_l = peak(xstar.x)
        lminfac = 0.6 * lmin

        kernels = [lambda x: gamma_l * gl(x / lminfac)]
        for i in range(Nf - 1):
            kernels.append(lambda x, i=i: gb(float(self.scales[i]) * x))
        super().__init__(G, kernels)

    def _get_extra_repr(self):
        return dict(lpfactor=f'{self.lpfactor:.2f}')
