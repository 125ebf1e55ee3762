"""Ring graph (counterpart of ``pygsp_tpu/graphs/ring.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch.graphs.graph import Graph


class Ring(Graph):
    """N vertices on a circle, each linked to its k nearest ring neighbors.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Ring(8, device='cpu')
    >>> G.N, G.Ne
    (8, 8)
    >>> bool((G.d == 2).all())       # every vertex has two neighbours
    True
    >>> G.coords.shape               # embedded on the unit circle
    (8, 2)

    """

    def __init__(self, N=64, k=1, **kwargs):
        self.k = k
        if N < 3:
            raise ValueError('There should be at least 3 vertices.')
        if 2 * k > N:
            raise ValueError('Too many neighbors requested.')

        v = np.arange(N)
        src, tgt = [], []
        for i in range(min(k, (N - 1) // 2)):
            nb = np.remainder(v + i + 1, N)
            src += [v, nb]
            tgt += [nb, v]
        if 2 * k == N:  # antipodal links appear once
            nb = np.remainder(v + k, N)
            src.append(v)
            tgt.append(nb)
        src = np.concatenate(src)
        tgt = np.concatenate(tgt)
        W = sps.csr_matrix((np.ones(len(src)), (src, tgt)), shape=(N, N))
        W.data[:] = 1.0  # duplicate antipodal entries collapse to weight 1

        plotting = {'limits': np.array([-1, 1, -1, 1])}
        super().__init__(W, plotting=plotting, **kwargs)
        self.set_coordinates('ring2D')

    def _get_extra_repr(self):
        return dict(k=self.k)
