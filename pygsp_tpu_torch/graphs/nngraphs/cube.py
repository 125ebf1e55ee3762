"""Sampled cube surface (counterpart of
``pygsp_tpu/graphs/nngraphs/cube.py``)."""

import numpy as np

from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class Cube(NNGraph):
    """Random points on the unit cube's faces (or in the unit square for
    ``nb_dim=2``), kNN graph. The points come from
    ``numpy.random.RandomState(seed)``, as in the JAX package.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Cube(nb_pts=64, seed=6, device='cpu')
    >>> G.coords.shape               # 6 faces of 64 // 6 points
    (60, 3)
    """

    def __init__(self, radius=1, nb_pts=300, nb_dim=3, sampling='random',
                 seed=None, **kwargs):
        self.radius = radius
        self.nb_pts = nb_pts
        self.nb_dim = nb_dim
        self.sampling = sampling
        self.seed = seed
        rs = np.random.RandomState(seed)

        if nb_dim > 3:
            raise NotImplementedError('Dimension > 3 not supported yet!')
        if sampling != 'random':
            raise ValueError('Unknown sampling !')

        if nb_dim == 2:
            pts = rs.rand(nb_pts, 2)
        else:
            n = nb_pts // 6
            pts = np.zeros((6 * n, 3))
            pts[:n, 1:] = rs.rand(n, 2)                           # x = 0
            pts[n:2 * n, 0] = 1                                   # x = 1
            pts[n:2 * n, 1:] = rs.rand(n, 2)
            pts[2 * n:3 * n, 0] = rs.rand(n)                      # y = 0
            pts[2 * n:3 * n, 2] = rs.rand(n)
            pts[3 * n:4 * n, 0] = rs.rand(n)                      # y = 1
            pts[3 * n:4 * n, 1] = 1
            pts[3 * n:4 * n, 2] = rs.rand(n)
            pts[4 * n:5 * n, :2] = rs.rand(n, 2)                  # z = 0
            pts[5 * n:6 * n, :2] = rs.rand(n, 2)                  # z = 1
            pts[5 * n:6 * n, 2] = 1

        plotting = {'vertex_size': 80, 'elevation': 15, 'azimuth': 0,
                    'distance': 9}
        super().__init__(Xin=pts, k=10, center=False, rescale=False,
                         plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        attrs = {'radius': f'{self.radius:.2f}', 'nb_pts': self.nb_pts,
                 'nb_dim': self.nb_dim, 'sampling': self.sampling,
                 'seed': self.seed}
        attrs.update(super()._get_extra_repr())
        return attrs
