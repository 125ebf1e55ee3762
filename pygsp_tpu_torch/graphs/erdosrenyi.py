"""Erdős–Rényi graph (counterpart of ``pygsp_tpu/graphs/erdosrenyi.py``)."""

from pygsp_tpu_torch.graphs.stochasticblockmodel import StochasticBlockModel


class ErdosRenyi(StochasticBlockModel):
    """G(N, p): an SBM with a single community.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.ErdosRenyi(50, p=0.2, seed=7, device='cpu')
    >>> G.N
    50
    >>> bool(abs(G.Ne / (50 * 49 / 2) - 0.2) < 0.05)  # ~p of all pairs
    True

    """

    def __init__(self, N=100, p=0.1, directed=False, self_loops=False,
                 connected=False, n_try=10, seed=None, **kwargs):
        super().__init__(N=N, k=1, p=p, directed=directed,
                         self_loops=self_loops, connected=connected,
                         n_try=n_try, seed=seed, **kwargs)

    def _get_extra_repr(self):
        return dict(p=f'{float(self.p):.2f}' if not hasattr(self.p, '__len__')
                    else self.p, directed=self.directed, seed=self.seed)
