"""Random ring graph (counterpart of ``pygsp_tpu/graphs/randomring.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


class RandomRing(Graph):
    """Random angles on a circle; consecutive points linked with weight
    inversely proportional to their angular gap.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.RandomRing(10, seed=1, device='cpu')
    >>> G.N, G.Ne                    # ring topology, random arc positions
    (10, 10)
    >>> bool((G.d == 2).all())
    True

    """

    def __init__(self, N=64, angles=None, seed=None, **kwargs):
        self.seed = seed
        if angles is None:
            rng = np.random.default_rng(seed)
            angles = np.sort(rng.uniform(0, 2 * np.pi, size=N))
        else:
            angles = np.sort(np.asanyarray(angles))
            N = len(angles)
            if np.any(angles < 0) or np.any(angles >= 2 * np.pi):
                raise ValueError('Angles should be in [0, 2 pi]')
        self.angles = angles
        if N < 3:
            raise ValueError('There should be at least 3 vertices.')

        rows = np.concatenate([np.arange(N - 1), [0]])
        cols = np.concatenate([np.arange(1, N), [N - 1]])
        weights = np.concatenate([np.diff(angles),
                                  [2 * np.pi + angles[0] - angles[-1]]])
        W = sps.coo_matrix((weights, (rows, cols)), shape=(N, N))
        W = utils.symmetrize(W, method='triu').tocoo()
        W.data = (2 * np.pi / N) / W.data

        coords = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        plotting = {'limits': np.array([-1, 1, -1, 1])}
        super().__init__(W, coords=coords, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(seed=self.seed)
