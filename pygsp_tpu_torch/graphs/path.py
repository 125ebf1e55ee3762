"""Path graph (counterpart of ``pygsp_tpu/graphs/path.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch.graphs.graph import Graph


class Path(Graph):
    """Chain of N vertices; optionally directed.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Path(5, device='cpu')
    >>> G.N, G.Ne
    (5, 4)
    >>> int(G.d.min()), int(G.d.max())   # two endpoints, three interior
    (1, 2)
    >>> G.is_connected()
    True

    """

    def __init__(self, N=16, directed=False, **kwargs):
        self.directed = directed
        src = np.arange(N - 1)
        tgt = np.arange(1, N)
        if not directed:
            src, tgt = np.concatenate([src, tgt]), np.concatenate([tgt, src])
        W = sps.csr_matrix((np.ones(len(src)), (src, tgt)), shape=(N, N))
        plotting = {'limits': np.array([-1, N, -1, 1])}
        super().__init__(W, plotting=plotting, **kwargs)
        self.set_coordinates('line2D')

    def _get_extra_repr(self):
        return dict(directed=self.directed)
