"""Airfoil mesh (counterpart of ``pygsp_tpu/graphs/airfoil.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


class Airfoil(Graph):
    """Airfoil mesh, N=4253, 12289 stored edges symmetrized by averaging.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Airfoil(device='cpu')
    >>> G.N, G.Ne
    (4253, 12289)
    >>> G.coords.shape
    (4253, 2)

    """

    def __init__(self, **kwargs):
        data = utils.loadmat('airfoil')
        coords = np.concatenate([data['x'], data['y']], axis=1)
        i_inds = np.reshape(data['i_inds'] - 1, -1)
        j_inds = np.reshape(data['j_inds'] - 1, -1)
        A = sps.coo_matrix((np.ones(len(i_inds)), (i_inds, j_inds)),
                           shape=(4253, 4253))
        W = (A + A.T) / 2.0

        plotting = {'vertex_size': 30,
                    'limits': np.array([-1e-4, 1.01 * data['x'].max(),
                                        -1e-4, 1.01 * data['y'].max()])}
        super().__init__(W, coords=coords, plotting=plotting, **kwargs)
