"""Stochastic block model — vectorized, streaming edge sampler.

Counterpart of ``pygsp_tpu/graphs/stochasticblockmodel.py``, the same NumPy
code on the host, so that a seed gives the same graph. It replaces the
reference's O(N²) scalar rejection loop
(``pygsp/graphs/stochasticblockmodel.py:126-137``) with per-block-pair binomial
sampling: for each (a, b) community pair the edge count is drawn from
Binomial(#candidate pairs, M[a,b]) and that many candidate indices are sampled
uniformly, so cost is O(|E|) and N=10⁶+ graphs are practical — a requirement of
the BASELINE scale targets. The sampled distribution is the same G(z, M)
ensemble; only the RNG stream differs from the reference.
"""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph


def _sample_distinct(rng, count, m):
    """m distinct integers from [0, count) (expects m << count)."""
    if m <= 0:
        return np.empty(0, dtype=np.int64)
    if m >= count:
        return np.arange(count, dtype=np.int64)
    out = np.unique(rng.integers(0, count, size=int(m * 1.05) + 8))
    while out.size < m:
        extra = rng.integers(0, count, size=m - out.size + 8)
        out = np.unique(np.concatenate([out, extra]))
    return rng.permutation(out)[:m]


def _tri_unrank(t):
    """Map linear index t to (r, c) with r > c in the strict lower triangle."""
    r = ((1.0 + np.sqrt(1.0 + 8.0 * t.astype(np.float64)))
         / 2.0).astype(np.int64)
    # float rounding correction
    r = np.where(r * (r - 1) // 2 > t, r - 1, r)
    r = np.where((r + 1) * r // 2 <= t, r + 1, r)
    c = t - r * (r - 1) // 2
    return r, c


def sbm_edges(z, M, *, directed=False, self_loops=False, rng=None):
    """Sample COO edges (one direction only for undirected) of an SBM."""
    if rng is None:
        rng = np.random.default_rng()
    z = np.asarray(z)
    k = M.shape[0]
    members = [np.flatnonzero(z == a) for a in range(k)]
    rows_all, cols_all = [], []

    for a in range(k):
        na = len(members[a])
        # within-block pairs
        p = M[a, a]
        if p > 0 and na > 1:
            if directed:
                count = na * (na - 1)
                m = rng.binomial(count, p)
                t = _sample_distinct(rng, count, m)
                r, c = t // (na - 1), t % (na - 1)
                c = np.where(c >= r, c + 1, c)  # skip the diagonal
            else:
                count = na * (na - 1) // 2
                m = rng.binomial(count, p)
                t = _sample_distinct(rng, count, m)
                r, c = _tri_unrank(t)
            rows_all.append(members[a][r])
            cols_all.append(members[a][c])
        if self_loops and p > 0 and na > 0:
            m = rng.binomial(na, p)
            sel = _sample_distinct(rng, na, m)
            rows_all.append(members[a][sel])
            cols_all.append(members[a][sel])
        # cross-block pairs
        bs = range(k) if directed else range(a)
        for b in bs:
            if b == a:
                continue
            nb = len(members[b])
            p = M[a, b]
            if p <= 0 or na == 0 or nb == 0:
                continue
            count = na * nb
            m = rng.binomial(count, p)
            t = _sample_distinct(rng, count, m)
            rows_all.append(members[a][t // nb])
            cols_all.append(members[b][t % nb])

    if rows_all:
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
    else:
        rows = cols = np.empty(0, dtype=np.int64)
    return rows, cols


class StochasticBlockModel(Graph):
    """SBM with community labels z and k×k probability matrix M
    (diag p, off-diag q). API matches the reference
    (``stochasticblockmodel.py:61-160``); see module docstring for the
    vectorized construction.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.StochasticBlockModel(N=90, k=3, p=0.5, q=0.05,
    ...                                 seed=3, device='cpu')
    >>> G.N
    90
    >>> G.info['node_com'].shape     # the planted community of each vertex
    (90,)
    >>> len(np.unique(G.info['node_com']))
    3

    """

    def __init__(self, N=1024, k=5, z=None, M=None, p=0.7, q=None,
                 directed=False, self_loops=False, connected=False,
                 n_try=10, seed=None, **kwargs):
        self.k = k
        self.directed = directed
        self.self_loops = self_loops
        self.connected = connected
        self.n_try = n_try
        self.seed = seed

        rng = np.random.default_rng(seed)
        if z is None:
            z = rng.integers(0, k, N)
            z.sort()
        self.z = z = np.asarray(z)

        if M is None:
            self.p = p
            p = np.asanyarray(p, dtype=float)
            if p.size == 1:
                p = p * np.ones(k)
            if p.shape != (k,):
                raise ValueError('Optional parameter p is neither a scalar '
                                 'nor a vector of length k.')
            if q is None:
                q = 0.3 / k
            self.q = q
            q = np.asanyarray(q, dtype=float)
            if q.size == 1:
                q = q * np.ones((k, k))
            if q.shape != (k, k):
                raise ValueError('Optional parameter q is neither a scalar '
                                 'nor a matrix of size k x k.')
            M = q.copy()
            M.flat[::k + 1] = p
        self.M = M = np.asarray(M, dtype=float)

        if (M < 0).any() or (M > 1).any():
            raise ValueError('Probabilities should be in [0, 1].')

        tries = n_try if n_try is not None else -1
        while True:
            rows, cols = sbm_edges(z, M, directed=directed,
                                   self_loops=self_loops, rng=rng)
            W = sps.csr_matrix((np.ones(len(rows)), (rows, cols)),
                               shape=(N, N))
            if not directed:
                W = utils.symmetrize(W, method='tril')
            if not connected:
                break
            n_comp, _ = sps.csgraph.connected_components(
                W, directed=directed,
                connection='strong' if directed else 'weak')
            if n_comp == 1:
                break
            if tries > 0:
                tries -= 1
            if tries == 0:
                raise ValueError(
                    f'The graph could not be connected after {n_try} trials. '
                    'Increase the connection probability.')

        self.info = {'node_com': z, 'comm_sizes': np.bincount(z, minlength=k),
                     'world_rad': np.sqrt(N)}
        super().__init__(W, **kwargs)

    def _get_extra_repr(self):
        attrs = dict(k=self.k)
        if isinstance(getattr(self, 'p', None), (int, float)):
            attrs['p'] = f'{self.p:.2f}'
        if isinstance(getattr(self, 'q', None), (int, float)):
            attrs['q'] = f'{self.q:.2f}'
        attrs.update(directed=self.directed, self_loops=self.self_loops,
                     connected=self.connected, seed=self.seed)
        return attrs
