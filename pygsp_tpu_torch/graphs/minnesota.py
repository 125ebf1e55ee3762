"""Minnesota road network, the counterpart of
``pygsp_tpu/graphs/minnesota.py``."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


class Minnesota(Graph):
    """Road network, N=2642; ``connected=True`` adds the fix-up edge.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Minnesota(device='cpu')
    >>> G.N, G.Ne
    (2642, 3304)
    >>> G.is_connected()
    True

    """

    def __init__(self, connected=True, **kwargs):
        self.connected = connected
        data = utils.loadmat('minnesota')
        self.labels = data['labels']
        A = data['A']

        plotting = {'limits': np.array([-98, -89, 43, 50]), 'vertex_size': 40}

        if connected:
            A = sps.lil_matrix(A)
            A[348, 354] = 1
            A[354, 348] = 1
            A = (sps.csc_matrix(A) > 0).astype(bool)

        super().__init__(A, coords=data['xy'], plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(connected=self.connected)
