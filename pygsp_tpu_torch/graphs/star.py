"""Star graph (counterpart of ``pygsp_tpu/graphs/star.py``)."""

from pygsp_tpu_torch.graphs.comet import Comet


class Star(Comet):
    """Star = comet with all N-1 vertices as rays.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Star(6, device='cpu')
    >>> G.N, G.Ne
    (6, 5)
    >>> int(G.d[0])                  # the hub connects to every leaf
    5
    >>> bool((G.d[1:] == 1).all())
    True

    """

    def __init__(self, N=10, **kwargs):
        plotting = dict(limits=[-1.1, 1.1, -1.1, 1.1])
        plotting.update(kwargs.pop('plotting', {}))
        super().__init__(N, N - 1, plotting=plotting, **kwargs)

    def _get_extra_repr(self):
        return dict()
