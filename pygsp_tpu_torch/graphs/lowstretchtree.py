"""Low-stretch tree (counterpart of ``pygsp_tpu/graphs/lowstretchtree.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch.graphs.graph import Graph


class LowStretchTree(Graph):
    """Recursive H-tree spanning a 2^k × 2^k grid.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.LowStretchTree(k=3, device='cpu')
    >>> G.N                          # 4**k vertices on a 2**k x 2**k grid
    64
    >>> G.coords.shape
    (64, 2)

    """

    def __init__(self, k=6, **kwargs):
        self.k = k

        x = np.array([1, 2, 1, 2], dtype=int)
        y = np.array([1, 1, 2, 2], dtype=int)
        ii = np.array([0, 0, 1, 2, 2, 3], dtype=int)
        jj = np.array([1, 2, 1, 3, 0, 2], dtype=int)

        for p in range(1, k):
            q = 4 ** p
            # four translated copies plus the three H-bar connector edges
            conn_i = [q - 1, q - 1,
                      q + (4 ** (p + 1) + 2) // 3 - 1,
                      (5 * q + 1) // 3 - 1,
                      q + (4 ** (p + 1) + 2) // 3 - 1,
                      3 * q]
            conn_j = [(5 * q + 1) // 3 - 1,
                      q + (4 ** (p + 1) + 2) // 3 - 1,
                      3 * q,
                      q - 1,
                      q - 1,
                      q + (4 ** (p + 1) + 2) // 3 - 1]
            ii = np.concatenate([ii, ii + q, ii + 2 * q, ii + 3 * q, conn_i])
            jj = np.concatenate([jj, jj + q, jj + 2 * q, jj + 3 * q, conn_j])

            y = np.tile(y, 2)
            y = np.concatenate([y, y + 2 ** p])
            x = np.concatenate([x, x + 2 ** p])
            x = np.tile(x, 2)

        W = sps.csc_matrix((np.ones_like(ii), (ii, jj)))
        coords = np.stack([x, y], axis=1)
        self.root = 4 ** (k - 1)

        plotting = {'edges_width': 1.25, 'vertex_size': 75,
                    'limits': np.array([0, 2 ** k + 1, 0, 2 ** k + 1])}
        super().__init__(W, coords=coords, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(k=self.k)
