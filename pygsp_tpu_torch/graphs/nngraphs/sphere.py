"""Sampled sphere (counterpart of ``pygsp_tpu/graphs/nngraphs/sphere.py``)."""

import numpy as np

from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class Sphere(NNGraph):
    """Gaussian points normalized onto the unit sphere, kNN graph. The
    points come from ``numpy.random.RandomState(seed)``, as in the JAX
    package.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Sphere(nb_pts=64, seed=6, device='cpu')
    >>> G.N, bool(np.allclose(np.linalg.norm(G.coords, axis=1), 1.0))
    (64, True)
    """

    def __init__(self, radius=1, nb_pts=300, nb_dim=3, sampling='random',
                 seed=None, **kwargs):
        self.radius = radius
        self.nb_pts = nb_pts
        self.nb_dim = nb_dim
        self.sampling = sampling
        self.seed = seed

        if sampling != 'random':
            raise ValueError(f'Unknown sampling {sampling}')
        rs = np.random.RandomState(seed)
        pts = rs.normal(0, 1, (nb_pts, nb_dim))
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)

        plotting = {'vertex_size': 80}
        super().__init__(Xin=pts, k=10, center=False, rescale=False,
                         plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        attrs = {'radius': f'{self.radius:.2f}', 'nb_pts': self.nb_pts,
                 'nb_dim': self.nb_dim, 'sampling': self.sampling,
                 'seed': self.seed}
        attrs.update(super()._get_extra_repr())
        return attrs
