"""Random k-regular graph — vectorized pairing model.

Counterpart of ``pygsp_tpu/graphs/randomregular.py``, the same NumPy code on
the host, so that a seed gives the same graph. It replaces the reference's
one-half-edge-at-a-time rejection loop
(``pygsp/graphs/randomregular.py:49-139``) with a shuffled pairing of all
half-edges at once: shuffle the N·k half-edge list, pair consecutive entries,
keep the valid pairs (no loops/duplicates) and re-shuffle only the leftover
half-edges. Same pairing-model ensemble, O(|E|) per round.
"""

import numpy as np
import scipy.sparse as sps

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.graph import Graph

_logger = utils.build_logger(__name__)


class RandomRegular(Graph):
    """Every vertex has degree k (pairing/configuration model).

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.RandomRegular(32, k=4, seed=2, device='cpu')
    >>> G.N
    32
    >>> bool((G.d == 4).all())       # exactly k-regular
    True

    """

    def __init__(self, N=64, k=6, max_iter=10, seed=None, **kwargs):
        self.k = k
        self.max_iter = max_iter
        self.seed = seed
        if (N * k) % 2 == 1:
            raise ValueError('input error: N*d must be even!')

        rng = np.random.default_rng(seed)
        A = self._pair(N, k, rng, max_iter)
        super().__init__(A, **kwargs)
        self.is_regular()

    @staticmethod
    def _pair(N, k, rng, max_iter):
        for _ in range(max_iter):
            half = np.repeat(np.arange(N), k)
            edges = set()
            ok = True
            for _ in range(max_iter * 10):
                rng.shuffle(half)
                v1, v2 = half[0::2], half[1::2]
                valid = v1 != v2
                lo = np.minimum(v1, v2)
                hi = np.maximum(v1, v2)
                keys = lo.astype(np.int64) * N + hi
                # drop duplicates within this round and vs accepted edges
                _, first_idx = np.unique(keys, return_index=True)
                dup_mask = np.zeros(len(keys), dtype=bool)
                dup_mask[first_idx] = True
                if edges:
                    existing = np.fromiter(edges, dtype=np.int64,
                                           count=len(edges))
                    dup_mask &= ~np.isin(keys, existing)
                accept = valid & dup_mask
                edges.update(keys[accept].tolist())
                rejected = ~accept
                if not rejected.any():
                    break
                half = np.concatenate([v1[rejected], v2[rejected]])
                if len(half) <= 2 and len(np.unique(half)) == 1:
                    ok = False  # stuck: both leftovers on the same vertex
                    break
            else:
                ok = False
            if ok and not len(half[0:0]):
                if 2 * len(edges) == N * k:
                    keys = np.fromiter(edges, dtype=np.int64, count=len(edges))
                    lo, hi = keys // N, keys % N
                    A = sps.csr_matrix(
                        (np.ones(2 * len(lo)),
                         (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
                        shape=(N, N))
                    return A
        # graceful fallback: return best-effort pairing (reference also
        # warns rather than raising when not perfectly regular)
        keys = np.fromiter(edges, dtype=np.int64, count=len(edges))
        lo, hi = keys // N, keys % N
        return sps.csr_matrix(
            (np.ones(2 * len(lo)),
             (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
            shape=(N, N))

    def is_regular(self):
        """Warn if the produced graph is not simple k-regular
        (reference ``randomregular.py:141-` behavior)."""
        warn = False
        msg = 'The given matrix'
        if np.abs(self.W - self.W.T).sum() > 0:
            warn = True
            msg += ' is not symmetric,'
        if self.W.max() > 1:
            warn = True
            msg += ' has parallel edges,'
        if np.min(self.d) != np.max(self.d):
            warn = True
            msg += ' is not d-regular,'
        if self.W.diagonal().any():
            warn = True
            msg += ' has self loop.'
        if warn:
            _logger.warning(msg.rstrip(',') + '.')

    def _get_extra_repr(self):
        return dict(k=self.k, seed=self.seed)
