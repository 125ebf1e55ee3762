"""Filter banks over graph spectra.

Counterpart of :mod:`pygsp_tpu.filters.filter`: a bank is a list of scalar
kernels λ → g(λ) attached to a graph. ``method='chebyshev'`` runs the
recurrence of :mod:`pygsp_tpu_torch.ops.chebyshev` eagerly (there is no jit
cache), and with ``fixed_graph=True`` its constant-memory backward;
``'lanczos'`` the Krylov approximation of :mod:`pygsp_tpu_torch.ops.lanczos`;
``'exact'`` the graph's Fourier basis.

Signal convention is the rank-3 ``(N_NODES, N_SIGNALS, N_FEATURES)`` with
the same squeeze/expand ergonomics as the JAX package. The frame methods
(``localize``, ``estimate_frame_bounds``, ``compute_frame``,
``complement``, ``inverse``) build their kernels as torch functions of λ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.ops import chebyshev as cheby
from pygsp_tpu_torch.ops import lanczos as lanczos_mod

_logger = utils.build_logger(__name__)


def _ftype(x):
    """The float dtype a kernel's result takes for responses at ``x``: x's
    own, or the default one for integer x (``jnp.result_type(x, 1.0)``)."""
    return torch.result_type(x, 1.0)


class Filter:
    """A filter bank: list of spectral kernels attached to a graph.

    Kernels take and return tensors.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, filters
    >>> G = graphs.Grid2d(4, 4, device='cpu', dtype=torch.float64)
    >>> G.estimate_lmax(method='bounds')
    >>> g = filters.Filter(G, lambda x: 1.0 / (1.0 + x))
    >>> s = np.zeros(G.N); s[5] = 1.0
    >>> tuple(g.filter(s, order=30).shape)
    (16,)
    >>> (g + filters.Heat(G, scale=5)).Nf
    2
    """

    def __init__(self, G, kernels):
        self.G = G
        try:
            iter(kernels)
        except TypeError:
            kernels = [kernels]
        self._kernels = list(kernels)

        self.n_features_in, self.n_features_out = (1, len(self._kernels))
        self.shape = (self.n_features_out, self.n_features_in)
        self.n_filters = self.n_features_in * self.n_features_out
        self.Nf = self.n_filters

    # -- bank algebra -----------------------------------------------------

    def _get_extra_repr(self):
        return dict()

    def __repr__(self):
        attrs = {'in': self.n_features_in, 'out': self.n_features_out}
        attrs.update(self._get_extra_repr())
        s = ', '.join(f'{k}={v}' for k, v in attrs.items())
        return f'{type(self).__name__}({s})'

    def __len__(self):
        return self.n_filters

    def __getitem__(self, key):
        return Filter(self.G, self._kernels[key])

    def __add__(self, other):
        if not isinstance(other, Filter):
            return NotImplemented
        return Filter(self.G, self._kernels + other._kernels)

    def __call__(self, x):
        from pygsp_tpu_torch.graphs import Graph
        if isinstance(x, Graph):
            return Filter(x, self._kernels)
        return self.evaluate(x)

    def __matmul__(self, other):
        return self.filter(other)

    # -- evaluation -------------------------------------------------------

    def evaluate(self, x):
        """Kernel responses at graph frequencies x: returns (Nf, *x.shape)."""
        x = torch.as_tensor(x)
        return torch.stack([torch.as_tensor(k(x)) for k in self._kernels])

    # -- filtering --------------------------------------------------------

    def filter(self, s, method: str = 'chebyshev', order: int = 30,
               carry_dtype=None, carry_tol=None, vals_dtype=None,
               fixed_graph: bool = False):
        """Analysis (1 → Nf features) or synthesis (Nf → 1).

        ``s`` (numpy or tensor) is moved to the graph's device; the result
        is a squeezed tensor there. ``method``: ``'chebyshev'`` (order
        ``order``), ``'lanczos'`` (a Krylov space of ``order`` vectors per
        column) or ``'exact'`` (the Fourier basis, computed on first use).

        ``carry_dtype`` (chebyshev, chunked and windowed formats): the
        dtype the recurrence terms are carried in, e.g. ``torch.bfloat16``;
        it is gated by the a-priori error bound
        (:func:`~pygsp_tpu_torch.ops.chebyshev.carry_error_estimate`) of
        the bank's coefficients against ``carry_tol``. ``vals_dtype``
        (chunked and windowed formats): the dtype of the stored edge
        values; with both in bf16 the SpMM multiplies bf16 by bf16 (the
        fast mode of the JAX package's bench). On the CSR, ELL and banded
        formats both raise the JAX package's ``ValueError``.

        ``fixed_graph`` (chebyshev, analysis): route through
        :func:`~pygsp_tpu_torch.ops.chebyshev.cheby_op_fixed_graph`, whose
        backward is two fresh recurrences instead of 3K stored terms.
        Gradients flow to the signal and, through the coefficients, to any
        parameter the kernels close over; the graph gets none. Without it,
        the chebyshev method differentiates through its own Functions, in
        both directions, on every format and both devices: the analysis by
        :func:`~pygsp_tpu_torch.ops.chebyshev.cheby_op` (its m+1 terms
        kept), the synthesis by
        :func:`~pygsp_tpu_torch.ops.chebyshev.cheby_synthesis` (no term
        kept; its backward the analysis bank of the cotangent on the
        transpose); with ``carry_dtype`` or ``vals_dtype`` they raise
        ``ValueError`` there.
        """
        if fixed_graph and (carry_dtype is not None
                            or vals_dtype is not None):
            raise ValueError('fixed_graph does not combine with '
                             'carry_dtype/vals_dtype yet — the exact '
                             'path is the training configuration')
        if fixed_graph and method != 'chebyshev':
            raise ValueError('fixed_graph requires method="chebyshev" — '
                             'the constant-memory VJP wraps the Chebyshev '
                             'recurrence only')
        s = self.G._check_signal(s)
        if s.ndim == 1 or s.shape[-1] not in (1, self.Nf):
            if s.ndim == 3:
                raise ValueError(
                    f'Third dimension (#features) should be either 1 or the '
                    f'number of filters Nf = {self.Nf}, got {tuple(s.shape)}.')
            s = s[..., None]
        n_features_in = s.shape[-1]
        if s.ndim < 3:
            s = s[:, None]
        if s.ndim > 3:
            raise ValueError('At most 3 dimensions: '
                             '#nodes x #signals x #features.')
        s = torch.as_tensor(s, device=self.G.device)

        if method == 'exact':
            f = self.evaluate(self.G.e).T                 # (N, Nf)
            f = f.unsqueeze(1 if n_features_in == 1 else 2)
            s_hat = self.G.gft(s)
            out = self.G.igft(torch.matmul(s_hat, f.to(s_hat.dtype)))
        elif method == 'chebyshev':
            out = self._chebyshev(s, order, carry_dtype, carry_tol,
                                  vals_dtype, fixed_graph)
        elif method == 'lanczos':
            if n_features_in == 1:
                r = lanczos_mod.lanczos_op(self.G.L, self.evaluate,
                                           s[..., 0], order=order)
                out = torch.movedim(r, 0, -1)
            else:
                out = lanczos_mod.lanczos_synthesis_op(
                    self.G.L, self.evaluate, s, order=order)[..., None]
        else:
            raise ValueError(f'Unknown method {method}.')
        return out.squeeze()

    def _chebyshev(self, s, order, carry_dtype, carry_tol, vals_dtype,
                   fixed_graph):
        """The Chebyshev recurrence on ``s`` (N, S, features in): (N, S,
        features out)."""
        lmax = float(self.G.lmax)
        if carry_dtype is not None:
            # the gate of the JAX package's program build: coefficients in
            # the default dtype, whatever the signal's
            cheby._check_carry_budget(
                cheby.cheby_coeff(self.evaluate, lmax, m=order,
                                  device=s.device), carry_dtype, carry_tol)
        c = cheby.cheby_coeff(self.evaluate, lmax, m=order, dtype=s.dtype,
                              device=s.device)
        kw = dict(carry_dtype=carry_dtype, carry_tol=carry_tol,
                  vals_dtype=vals_dtype)
        if s.shape[-1] == 1:                             # analysis
            if fixed_graph:
                r = cheby.cheby_op_fixed_graph(self.G.L, lmax, c, s[..., 0])
            else:
                r = cheby.cheby_op(self.G.L, lmax, c, s[..., 0], **kw)
            return torch.movedim(r, 0, -1)               # (N, S, Nf)
        if fixed_graph:
            raise ValueError('fixed_graph supports the analysis direction '
                             '(1 -> Nf features); differentiate that side')
        return cheby.cheby_synthesis(self.G.L, lmax, c, s, **kw)[..., None]

    def analyze(self, s, method='chebyshev', order=30):
        if not isinstance(s, torch.Tensor):
            s = np.asanyarray(s)
        if s.ndim == 3 and s.shape[-1] != 1:
            raise ValueError(f'Last dimension (#features) should be 1, '
                             f'got {tuple(s.shape)}.')
        return self.filter(s, method, order)

    def synthesize(self, s, method='chebyshev', order=30):
        if not isinstance(s, torch.Tensor):
            s = np.asanyarray(s)
        if s.shape[-1] != self.Nf:
            raise ValueError(f'Last dimension (#features) should be the '
                             f'number of filters Nf = {self.Nf}, got '
                             f'{tuple(s.shape)}.')
        return self.filter(s, method, order)

    def localize(self, i, **kwargs):
        """Filter √N·δᵢ to show the kernels in the vertex domain; ``kwargs``
        go to :meth:`filter`.

        Examples
        --------
        >>> import torch
        >>> from pygsp_tpu_torch import graphs, filters
        >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
        >>> G.estimate_lmax()
        >>> g = filters.Heat(G, scale=[5, 20])
        >>> tuple(g.localize(9).shape)   # the two atoms centred at v=9
        (64, 2)
        """
        s = torch.zeros(self.G.N, dtype=self.G.dtype, device=self.G.device)
        s[i] = 1.0
        return math.sqrt(self.G.N) * self.filter(s, **kwargs)

    # -- frame machinery --------------------------------------------------

    def estimate_frame_bounds(self, x=None):
        """``(A, B)``, the least and the largest of Σᵢ gᵢ²(x) over ``x``
        (default 1000 points spanning [0, λmax]), as Python floats.

        Examples
        --------
        >>> import torch
        >>> from pygsp_tpu_torch import graphs, filters
        >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
        >>> G.estimate_lmax()
        >>> A, B = filters.Itersine(G, Nf=5).estimate_frame_bounds()
        >>> print(round(B / A, 2))     # tight frame
        1.0
        """
        if x is None:
            x = torch.linspace(0, self.G.lmax, 1000, dtype=self.G.dtype,
                               device=self.G.device)
        else:
            x = torch.as_tensor(x, device=self.G.device)
        s = torch.sum(self.evaluate(x) ** 2, dim=0)
        return float(torch.min(s)), float(torch.max(s))

    def compute_frame(self, **kwargs):
        """The analysis operator as a (N·Nf, N) matrix, by filtering the
        identity (``kwargs`` go to :meth:`filter`). Small graphs only.

        Examples
        --------
        >>> import torch
        >>> from pygsp_tpu_torch import graphs, filters
        >>> G = graphs.Grid2d(4, 4, device='cpu', dtype=torch.float64)
        >>> G.estimate_lmax()
        >>> g = filters.Heat(G, scale=[5, 20])
        >>> tuple(g.compute_frame().shape)   # Nf*N atoms as rows
        (32, 16)
        """
        if self.G.N > 2000:
            _logger.warning('Creating a big matrix. '
                            'You should prefer the filter method.')
        s = torch.eye(self.G.N, dtype=self.G.dtype, device=self.G.device)
        out = self.filter(s, **kwargs)
        return out.permute(*reversed(range(out.ndim))).reshape(-1, self.G.N)

    def toarray(self):
        return self.compute_frame()

    def complement(self, frame_bound=None):
        """The kernel √(B − Σg²) that makes the bank a tight frame of bound
        B: by default the largest Σg² at the points it is evaluated on;
        ``frame_bound`` raises ``ValueError`` below that.

        Examples
        --------
        >>> import numpy as np, torch
        >>> from pygsp_tpu_torch import graphs, filters
        >>> G = graphs.Grid2d(8, 8, device='cpu', dtype=torch.float64)
        >>> G.estimate_lmax()
        >>> g = filters.Heat(G, scale=10)
        >>> gc = g + g.complement()           # saturate the frame
        >>> lam = torch.linspace(0, G.lmax, 5, dtype=torch.float64)
        >>> v = (gc.evaluate(lam) ** 2).sum(dim=0)
        >>> print(np.round(v.numpy(), 2))     # now exactly tight
        [1. 1. 1. 1. 1.]
        """
        def kernel(x):
            y = torch.sum(self.evaluate(x) ** 2, dim=0)
            if frame_bound is None:
                bound = torch.max(y)
            else:
                _, B = self.estimate_frame_bounds(x)
                if B > frame_bound:
                    raise ValueError(f'The chosen bound is not feasible. '
                                     f'Choose at least {B}.')
                bound = frame_bound
            return torch.sqrt(torch.clamp(bound - y, min=0.0))
        return Filter(self.G, kernel)

    def plot(self, **kwargs):
        """Draw the kernels' responses
        (:func:`pygsp_tpu_torch.plotting.plot_filter`)."""
        from pygsp_tpu_torch import plotting
        return plotting.plot_filter(self, **kwargs)

    def inverse(self):
        """The canonical dual bank gᵢ⁺ = gᵢ / Σⱼ gⱼ² (the pseudo-inverse),
        with a warning if the bank is not a frame or is badly
        conditioned."""
        A, B = self.estimate_frame_bounds()
        if A == 0:
            _logger.warning('The filter bank is not invertible as it is not '
                            'a frame (lower frame bound A=0).')
        elif A / B < 1e-10:
            _logger.warning('The filter bank is badly conditioned. '
                            'The inverse will be approximate.')

        def make_kernel(i):
            def kernel(x):
                y = self.evaluate(x)               # (Nf, len(x))
                denom = torch.sum(y ** 2, dim=0)
                nonzero = denom > 0
                return torch.where(
                    nonzero, y[i] / torch.where(nonzero, denom, 1.0), 0.0)
            return kernel

        return Filter(self.G, [make_kernel(i) for i in range(self.n_filters)])
