"""Wave-propagation kernel bank."""

from __future__ import annotations

import torch

from pygsp_tpu_torch.filters.filter import Filter


class Wave(Filter):
    r"""``g(x) = cos(t·arccos(1 − s²x/(2·lmax)))`` per (time, speed) pair;
    ``G.lmax`` is read when the kernel is evaluated.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax()
    >>> g = filters.Wave(G, time=[5, 15], speed=1)
    >>> g.Nf
    2
    >>> g.evaluate(torch.zeros(1, dtype=torch.float64)).tolist()
    [[1.0], [1.0]]
    >>> s = np.zeros(G.N); s[3] = 1.0
    >>> tuple(g.filter(s, order=30).shape)
    (64, 2)
    """

    def __init__(self, G, time=10, speed=1):
        try:
            iter(time)
        except TypeError:
            time = [time]
        try:
            iter(speed)
        except TypeError:
            speed = [speed]
        self.time = list(time)
        self.speed = list(speed)

        time, speed = self.time, self.speed
        if len(time) != len(speed):
            if len(speed) == 1:
                speed = speed * len(time)
            elif len(time) == 1:
                time = time * len(speed)
            else:
                raise ValueError('If both parameters are iterable, '
                                 'they should have the same length.')
        if any(s >= 2 for s in speed):
            raise ValueError('The wave propagation speed should be in [0, 2[')

        def kernel(x, t, s):
            arg = torch.clamp(1.0 - s ** 2 * x / G.lmax / 2.0, -1.0, 1.0)
            return torch.cos(t * torch.arccos(arg))

        kernels = [lambda x, t=t, s=s: kernel(x, t, s)
                   for t, s in zip(time, speed)]
        super().__init__(G, kernels)

    def _get_extra_repr(self):
        time = '[' + ', '.join(f'{t:.2f}' for t in self.time) + ']'
        speed = '[' + ', '.join(f'{s:.2f}' for s in self.speed) + ']'
        return dict(time=time, speed=speed)
