"""Comet graph (counterpart of ``pygsp_tpu/graphs/comet.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch.graphs.graph import Graph


class Comet(Graph):
    """Star of k rays around vertex 0 plus a tail path.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Comet(12, k=5, device='cpu')
    >>> G.N, G.Ne                    # a tree: 5-star head + tail
    (12, 11)
    >>> int(G.d[0])                  # the head vertex
    5

    """

    def __init__(self, N=32, k=12, **kwargs):
        if k > N - 1:
            raise ValueError(f'The degree of the central vertex k={k} must '
                             f'be smaller than the number of vertices N={N}.')
        self.k = k

        star_src = np.zeros(k, dtype=int)
        star_tgt = np.arange(k) + 1
        tail_src = np.arange(k, N - 1)
        tail_tgt = np.arange(k + 1, N)
        src = np.concatenate([star_src, star_tgt, tail_src, tail_tgt])
        tgt = np.concatenate([star_tgt, star_src, tail_tgt, tail_src])
        W = sps.csr_matrix((np.ones(len(src)), (src, tgt)), shape=(N, N))

        coords = np.zeros((N, 2))
        rays = np.arange(k) + 1
        coords[1:k + 1, 0] = np.cos(rays * 2 * np.pi / k)
        coords[1:k + 1, 1] = np.sin(rays * 2 * np.pi / k)
        coords[k + 1:, 0] = np.arange(1, N - k) + 1

        super().__init__(W, coords=coords, **kwargs)

    def _get_extra_repr(self):
        return dict(k=self.k)
