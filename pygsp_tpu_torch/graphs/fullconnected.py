"""Fully connected graph, the counterpart of
``pygsp_tpu/graphs/fullconnected.py``."""

import numpy as np

from pygsp_tpu_torch.graphs.graph import Graph


class FullConnected(Graph):
    """All-ones adjacency minus the diagonal.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.FullConnected(8, device='cpu')
    >>> G.N, G.Ne
    (8, 28)
    >>> bool((G.d == 7).all())
    True

    """

    def __init__(self, N=10, **kwargs):
        W = np.ones((N, N)) - np.identity(N)
        plotting = {'limits': np.array([-1, 1, -1, 1])}
        super().__init__(W, plotting=plotting, **kwargs)
