"""Swiss-roll point cloud graph, the counterpart of
``pygsp_tpu/graphs/swissroll.py``."""

import numpy as np

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


class SwissRoll(Graph):
    """Sampled swiss-roll manifold → Gaussian distance kernel, thresholded.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.SwissRoll(N=100, seed=5, device='cpu')
    >>> G.N
    100
    >>> G.coords.shape               # points on the rolled 2-manifold
    (100, 3)

    """

    def __init__(self, N=400, a=1, b=4, dim=3, thresh=1e-6, s=None,
                 noise=False, srtype='uniform', seed=None, **kwargs):
        if s is None:
            s = np.sqrt(2.0 / N)
        self.a, self.b, self.dim = a, b, dim
        self.thresh, self.s = thresh, s
        self.noise, self.srtype, self.seed = noise, srtype, seed

        rng = np.random.default_rng(seed)
        y1 = rng.uniform(size=N)
        y2 = rng.uniform(size=N)
        if srtype == 'uniform':
            tt = np.sqrt((b * b - a * a) * y1 + a * a)
        elif srtype == 'classic':
            tt = (b - a) * y1 + a
        else:
            raise ValueError(f'Unknown srtype {srtype!r}')
        tt = tt * np.pi

        if dim == 2:
            x = np.array([tt * np.cos(tt), tt * np.sin(tt)])
        elif dim == 3:
            x = np.array([tt * np.cos(tt), 21 * y2, tt * np.sin(tt)])
        else:
            raise ValueError('dim must be 2 or 3')
        if noise:
            x = x + rng.normal(size=x.shape)
        self.x = x

        coords = utils.rescale_center(x)
        dist = utils.distanz(coords)
        W = np.exp(-dist ** 2 / (2.0 * s ** 2))
        np.fill_diagonal(W, 0)
        W[W < thresh] = 0

        plotting = {'vertex_size': 60,
                    'limits': np.array([-1, 1, -1, 1, -1, 1]),
                    'elevation': 15, 'azimuth': -90, 'distance': 7}
        super().__init__(W, coords=coords.T, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(srtype=self.srtype, seed=self.seed)
