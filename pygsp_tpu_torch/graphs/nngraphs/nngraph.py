"""Nearest-neighbour graph from a point cloud (counterpart of
``pygsp_tpu/graphs/nngraphs/nngraph.py``).

The construction is the JAX package's own host code: SciPy's ``KDTree``
finds the k nearest neighbours (``NNtype='knn'``) or every pair within
``epsilon`` (``'radius'``), the weights are the Gaussian kernel
``exp(-d²/σ)`` with σ the mean neighbour distance by default, and
:func:`~pygsp_tpu_torch.utils.symmetrize` makes W symmetric. ``Graph``
then puts W and L on ``device``. ``use_flann`` is accepted and ignored, as
in the JAX package.
"""

import numpy as np
import scipy.sparse as sps
from scipy import spatial

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph

_MINKOWSKI = {'euclidean': 2, 'manhattan': 1, 'max_dist': np.inf}


class NNGraph(Graph):
    """kNN or epsilon-radius graph over the rows of the features ``Xin``.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> pts = np.random.default_rng(0).normal(size=(50, 3))
    >>> G = graphs.NNGraph(pts, k=4, device='cpu')
    >>> G.N, G.coords.shape
    (50, (50, 3))
    """

    def __init__(self, Xin, NNtype='knn', use_flann=False, center=True,
                 rescale=True, k=10, sigma=None, epsilon=0.01, plotting=None,
                 symmetrize_type='average', dist_type='euclidean', order=0,
                 **kwargs):
        self.Xin = Xin = np.asarray(Xin, dtype=float)
        self.NNtype = NNtype
        self.use_flann = use_flann
        self.center = center
        self.rescale = rescale
        self.k = k
        self.sigma = sigma
        self.epsilon = epsilon
        self.symmetrize_type = symmetrize_type
        self.dist_type = dist_type
        self.order = order

        N, d = Xin.shape
        if k >= N:
            raise ValueError(f'The number of neighbors (k={k}) must be '
                             f'smaller than the number of nodes ({N}).')

        Xout = Xin
        if center:
            Xout = Xin - np.mean(Xin, axis=0, keepdims=True)
        if rescale:
            bounding_radius = 0.5 * np.linalg.norm(
                np.amax(Xout, axis=0) - np.amin(Xout, axis=0), 2)
            scale = np.power(N, 1.0 / min(d, 3)) / 10.0
            Xout = Xout * (scale / bounding_radius)

        p = _MINKOWSKI.get(dist_type, order)
        tree = spatial.KDTree(Xout)

        if NNtype == 'knn':
            D, NN = tree.query(Xout, k=k + 1, p=p)
            if self.sigma is None:
                self.sigma = np.mean(D[:, 1:])
            spi = np.repeat(np.arange(N), k)
            spj = NN[:, 1:].reshape(-1)
            spv = np.exp(-D[:, 1:].reshape(-1) ** 2 / float(self.sigma))
        elif NNtype == 'radius':
            pairs = tree.query_pairs(epsilon, p=p, output_type='ndarray')
            if len(pairs) == 0:
                raise ValueError('No neighbors found')
            diffs = Xout[pairs[:, 0]] - Xout[pairs[:, 1]]
            if p == 2:
                dists = np.linalg.norm(diffs, axis=1)
            elif p == np.inf:
                dists = np.abs(diffs).max(axis=1)
            else:
                dists = np.power(np.abs(diffs) ** p, 1).sum(axis=1) ** (1.0 / p)
            if self.sigma is None:
                self.sigma = np.mean(dists)
            vals = np.exp(-dists ** 2 / float(self.sigma))
            spi = np.concatenate([pairs[:, 0], pairs[:, 1]])
            spj = np.concatenate([pairs[:, 1], pairs[:, 0]])
            spv = np.concatenate([vals, vals])
        else:
            raise ValueError(f'Unknown NNtype {NNtype}')

        W = sps.csc_matrix((spv, (spi, spj)), shape=(N, N))
        W = utils.symmetrize(W, method=symmetrize_type)
        super().__init__(W, plotting=plotting or {}, coords=Xout, **kwargs)

    def _get_extra_repr(self):
        return {'NNtype': self.NNtype, 'use_flann': self.use_flann,
                'center': self.center, 'rescale': self.rescale, 'k': self.k,
                'sigma': f'{self.sigma:.2f}',
                'epsilon': f'{self.epsilon:.2f}',
                'symmetrize_type': self.symmetrize_type,
                'dist_type': self.dist_type, 'order': self.order}
