"""Torus graph (counterpart of ``pygsp_tpu/graphs/torus.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch.graphs.graph import Graph


class Torus(Graph):
    """Nv×Mv periodic 2-D lattice embedded on a 3-D torus.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Torus(4, 3, device='cpu')
    >>> G.N, G.Ne                    # 2N edges: every vertex has degree 4
    (12, 24)
    >>> bool((G.d == 4).all())
    True
    >>> G.coords.shape               # embedded in 3-D
    (12, 3)

    """

    def __init__(self, Nv=16, Mv=None, **kwargs):
        if Mv is None:
            Mv = Nv
        self.Nv, self.Mv = Nv, Mv
        n = Nv * Mv

        idx = np.arange(n)
        col = idx % Nv           # position inside a ring
        ring = idx // Nv         # which ring
        # neighbor within the ring (periodic) and to the next ring (periodic)
        right = ring * Nv + (col + 1) % Nv
        up = ((ring + 1) % Mv) * Nv + col
        src = np.concatenate([idx, right, idx, up])
        tgt = np.concatenate([right, idx, up, idx])
        W = sps.csr_matrix((np.ones(len(src)), (src, tgt)), shape=(n, n))
        W.data[:] = 1.0

        # 3-D coordinates on the torus surface
        t = 1.5 + np.sin(np.arange(Mv) * 2 * np.pi / Mv)
        u = np.cos(np.arange(Mv) * 2 * np.pi / Mv)
        phi = np.arange(Nv) * 2 * np.pi / Nv
        x = (np.cos(phi)[:, None] * t[None, :]).reshape(n, order='F')
        y = (np.sin(phi)[:, None] * t[None, :]).reshape(n, order='F')
        z = np.tile(u, (Nv, 1)).reshape(n, order='F')
        coords = np.stack([x, y, z], axis=1)

        plotting = {'vertex_size': 60,
                    'limits': np.array([-2.5, 2.5, -2.5, 2.5, -2.5, 2.5])}
        super().__init__(W, coords=coords, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict(Nv=self.Nv, Mv=self.Mv)
