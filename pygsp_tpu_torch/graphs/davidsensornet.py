"""David sensor network, the counterpart of
``pygsp_tpu/graphs/davidsensornet.py``."""

import numpy as np

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


class DavidSensorNet(Graph):
    """Fixed 64/500-vertex sensor nets from assets, or random generation.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.DavidSensorNet(N=64, device='cpu')
    >>> G.N
    64
    >>> G.coords.shape
    (64, 2)

    """

    def __init__(self, N=64, seed=None, **kwargs):
        self.seed = seed
        if N == 64:
            data = utils.loadmat('david64')
            assert data['N'][0, 0] == N
            W, coords = data['W'], data['coords']
        elif N == 500:
            data = utils.loadmat('david500')
            assert data['N'][0, 0] == N
            W, coords = data['W'], data['coords']
        else:
            coords = np.random.default_rng(seed).uniform(size=(N, 2))
            target_dist_cutoff = -0.125 * N / 436.075 + 0.2183
            T = 0.6
            s = np.sqrt(-target_dist_cutoff ** 2 / (2 * np.log(T)))
            d = utils.distanz(coords.T)
            W = np.exp(-d ** 2 / (2.0 * s ** 2))
            W[W < T] = 0
            np.fill_diagonal(W, 0)

        plotting = {'limits': [0, 1, 0, 1]}
        super().__init__(W, coords=coords, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(seed=self.seed)
