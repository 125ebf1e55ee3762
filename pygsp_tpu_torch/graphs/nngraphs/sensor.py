"""Random sensor graph (counterpart of
``pygsp_tpu/graphs/nngraphs/sensor.py``)."""

import numpy as np

from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class Sensor(NNGraph):
    """Uniform (or perturbed-grid) points in [0, 1]², kNN graph. The points
    are drawn from ``numpy.random.default_rng(seed)``, as in the JAX
    package.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Sensor(64, seed=42, device='cpu')
    >>> G.N, G.is_connected(), G.coords.shape
    (64, True, (64, 2))
    """

    def __init__(self, N=64, k=6, distributed=False, seed=None, **kwargs):
        self.distributed = distributed
        self.seed = seed
        plotting = {'limits': np.array([0, 1, 0, 1])}
        rng = np.random.default_rng(seed)

        if distributed:
            m = np.sqrt(N)
            if not m.is_integer():
                raise ValueError('The number of vertices must be a perfect '
                                 'square if they are to be distributed on '
                                 'a grid.')
            coords = np.mgrid[0:1:1 / m, 0:1:1 / m].reshape(2, -1).T
            coords = coords + rng.uniform(0, 1 / m, (N, 2))
        else:
            coords = rng.uniform(0, 1, (N, 2))

        super().__init__(Xin=coords, k=k, rescale=False, center=False,
                         plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return {'k': self.k, 'distributed': self.distributed,
                'seed': self.seed}
