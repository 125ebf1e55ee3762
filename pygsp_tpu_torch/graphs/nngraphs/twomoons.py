"""Two-moons graph (counterpart of
``pygsp_tpu/graphs/nngraphs/twomoons.py``)."""

import numpy as np

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class TwoMoons(NNGraph):
    """Two interleaving half-circles: the bundled 2000-point set
    (``moontype='standard'``) or points drawn from
    ``numpy.random.default_rng(seed)`` (``'synthesized'``), kNN graph.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.TwoMoons(moontype='synthesized', N=100, seed=7,
    ...                     device='cpu')
    >>> G.N, G.coords.shape, int(G.labels.sum())
    (100, (100, 2), 50)
    """

    def _create_arc_moon(self, N, sigmad, distance, number, seed):
        rng = np.random.default_rng(seed)
        phi = rng.uniform(size=(N, 1)) * np.pi
        rb = sigmad * rng.normal(size=(N, 1))
        ab = rng.uniform(size=(N, 1)) * 2 * np.pi
        b = rb * np.exp(1j * ab)
        bx, by = np.real(b), np.imag(b)
        if number == 1:
            moonx = np.cos(phi) + bx + 0.5
            moony = -np.sin(phi) + by - (distance - 1) / 2.0
        else:
            moonx = np.cos(phi) + bx - 0.5
            moony = np.sin(phi) + by + (distance - 1) / 2.0
        return np.concatenate([moonx, moony], axis=1)

    def __init__(self, moontype='standard', dim=2, sigmag=0.05, N=400,
                 sigmad=0.07, distance=0.5, seed=None, **kwargs):
        self.moontype = moontype
        self.dim = dim
        self.sigmag = sigmag
        self.sigmad = sigmad
        self.distance = distance
        self.seed = seed

        if moontype == 'standard':
            N1 = N2 = 1000
            data = utils.loadmat('two_moons')
            Xin = data['features'][:dim].T
        elif moontype == 'synthesized':
            N1 = N // 2
            N2 = N - N1
            Xin = np.concatenate([
                self._create_arc_moon(N1, sigmad, distance, 1, seed),
                self._create_arc_moon(N2, sigmad, distance, 2, seed)])
        else:
            raise ValueError(f'Unknown moontype {moontype}')

        self.labels = np.concatenate([np.zeros(N1), np.ones(N2)])
        plotting = {'vertex_size': 30}
        super().__init__(Xin=Xin, sigma=sigmag, k=5, center=False,
                         rescale=False, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        attrs = {'moontype': self.moontype, 'dim': self.dim,
                 'sigmag': f'{self.sigmag:.2f}',
                 'sigmad': f'{self.sigmad:.2f}',
                 'distance': f'{self.distance:.2f}', 'seed': self.seed}
        attrs.update(super()._get_extra_repr())
        return attrs
