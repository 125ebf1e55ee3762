"""Line graph (counterpart of ``pygsp_tpu/graphs/linegraph.py``)."""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph

_logger = utils.build_logger(__name__)


class LineGraph(Graph):
    """Graph whose vertices are the edges of the input graph:
    ``A = |D|ᵀ|D| − 2I`` over the binary incidence pattern.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Ring(6, device='cpu')
    >>> L = graphs.LineGraph(G)      # one vertex per edge of the ring
    >>> L.N == G.Ne
    True
    >>> L.Ne                         # ring line graph is again a 6-cycle
    6

    """

    def __init__(self, graph, **kwargs):
        # on the input graph's device and in its dtype unless told otherwise
        kwargs.setdefault('device', graph.device)
        kwargs.setdefault('dtype', graph.dtype)
        if graph.is_weighted():
            _logger.warning('Your graph is weighted, and is considered '
                            'unweighted to build a binary line graph.')
        graph.compute_differential_operator()
        incidence = (np.abs(graph.D.to_scipy()) > 0)
        adjacency = incidence.T.astype(int) @ incidence.astype(int)
        adjacency = adjacency - sps.identity(graph.n_edges, dtype=int) * 2

        coords = None
        if graph.coords is not None and graph.coords.ndim == 2:
            coords = incidence.T.astype(float) @ graph.coords / 2

        super().__init__(adjacency, coords=coords,
                         plotting=graph.plotting, **kwargs)
