"""The Graph class: host-side construction, device-side operators.

Counterpart of the core of :mod:`pygsp_tpu.graphs.graph`. The graph is a
thin host wrapper around one canonical scipy CSR adjacency (construction,
validation, predicates, degrees live on the host) plus operators on
``device``:

- ``W_op`` : padded row-sorted :class:`~pygsp_tpu_torch.core.sparse.CSRMatrix`
- ``L``    : :class:`~pygsp_tpu_torch.core.operators.LaplacianOp`
- ``D``    : the difference operator (``grad``/``div``), whose products run
  on the CSR SpMM kernel

``device`` defaults to ``'cuda'``; pass ``device='cpu'`` to run the plain
PyTorch versions of the kernels on the CPU. ``dtype`` is the operators'
float type, float32 by default.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.core import sparse as core_sparse
from pygsp_tpu_torch.core.chunked import CHUNK_ROWS
from pygsp_tpu_torch.core.operators import LaplacianOp, laplacian_op, matvec
from pygsp_tpu_torch.ops import eigen as ops_eigen

class Graph:
    """Weighted (un)directed graph with device-resident operators.

    ``adjacency`` is any square dense or sparse matrix; NaN/Inf raise;
    self-loops and negative weights warn.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> W = np.array([[0., 1., 0.],
    ...               [1., 0., 2.],
    ...               [0., 2., 0.]])
    >>> G = graphs.Graph(W, device='cpu')
    >>> G.N, G.Ne
    (3, 2)
    >>> G.dw
    array([1., 3., 2.])
    """

    def __init__(self, adjacency, lap_type: str = 'combinatorial',
                 coords=None, plotting=None, *, device='cuda',
                 dtype=torch.float32):
        self.logger = utils.build_logger(__name__)
        self.device = utils.check_device(device, 'Graph')
        self.dtype = dtype

        if sps.issparse(adjacency):
            adjacency = adjacency.tocsr().astype(np.float64)
        else:
            adjacency = sps.csr_matrix(np.asarray(adjacency, dtype=np.float64))
        if adjacency.shape[0] != adjacency.shape[1]:
            raise ValueError('Adjacency: must be a square matrix.')
        if np.isnan(adjacency.sum()):
            raise ValueError('Adjacency: there is a Not a Number (NaN).')
        if np.isinf(adjacency.sum()):
            raise ValueError('Adjacency: there is an infinite value.')

        adjacency.eliminate_zeros()
        self._adjacency = adjacency
        self.n_vertices = adjacency.shape[0]
        self._init_caches()

        if self.has_loops():
            self.logger.warning('Adjacency: there are self-loops '
                                '(non-zeros on the diagonal). '
                                'The Laplacian will not see them.')
        if (adjacency < 0).nnz != 0:
            self.logger.warning('Adjacency: there are negative edge weights.')

        # Count undirected edges once.
        if self.is_directed():
            self.n_edges = adjacency.nnz
        else:
            n_loops = np.count_nonzero(adjacency.diagonal())
            self.n_edges = (adjacency.nnz - n_loops) // 2 + n_loops

        self.coords = None if coords is None else np.asarray(coords)
        self.plotting = {'vertex_size': 100, 'vertex_color': (0.12, 0.47, 0.71, 0.5),
                         'edge_color': (0.5, 0.5, 0.5, 0.5), 'edge_width': 2,
                         'edge_style': '-', 'highlight_color': 'C1',
                         'normalize_intercept': .25}
        if plotting:
            self.plotting.update(plotting)
        self.signals = {}
        self.mr = None  # set by reduction.graph_multiresolution

        self.compute_laplacian(lap_type)

    def _init_caches(self):
        self._W_op = None
        self._L = None
        self._lmax = None
        self._lmax_method = None
        self._U = None
        self._e = None
        self._coherence = None
        self._D = None
        self._d = None
        self._dw = None
        self._directed = None
        self._connected = None

    # ------------------------------------------------------------------
    # basic attributes
    # ------------------------------------------------------------------

    @property
    def W(self):
        """Host scipy CSR adjacency (immutable)."""
        return self._adjacency

    @W.setter
    def W(self, value):
        raise AttributeError('In-place modification of the graph is not '
                             'supported. Build a new Graph object.')

    @property
    def A(self):
        """Binary (boolean) adjacency."""
        return self._adjacency > 0

    @property
    def N(self):
        return self.n_vertices

    @property
    def Ne(self):
        return self.n_edges

    @property
    def W_op(self) -> core_sparse.CSRMatrix:
        """The adjacency on ``device`` (row-sorted padded COO/CSR)."""
        if self._W_op is None:
            self._W_op = core_sparse.from_scipy(
                self._adjacency, dtype=self.dtype, device=self.device)
        return self._W_op

    def __repr__(self):
        attrs = {'n_vertices': self.n_vertices, 'n_edges': self.n_edges}
        s = ', '.join(f'{k}={v}' for k, v in attrs.items())
        return f'{type(self).__name__}({s})'

    # ------------------------------------------------------------------
    # structure predicates (host-side)
    # ------------------------------------------------------------------

    def is_weighted(self) -> bool:
        """False iff every edge weight is 1."""
        return not np.all(self._adjacency.data == 1)

    def is_directed(self) -> bool:
        """W != W.T anywhere."""
        if self._directed is None:
            self._directed = (self._adjacency != self._adjacency.T).nnz != 0
        return self._directed

    def has_loops(self) -> bool:
        return bool(np.any(self._adjacency.diagonal() != 0))

    def is_connected(self) -> bool:
        """Connectivity (strong for directed graphs), on the host."""
        if self._connected is None:
            n_comp, _ = sps.csgraph.connected_components(
                self._adjacency, directed=self.is_directed(),
                connection='strong' if self.is_directed() else 'weak')
            self._connected = n_comp == 1
        return self._connected

    def extract_components(self):
        """The connected components as subgraphs, each with
        ``info['orig_idx']``, its vertices in this graph. A directed graph
        logs an error and gives None."""
        if self.is_directed():
            self.logger.error('Directed graphs not supported yet.')
            return None
        n_comp, labels = sps.csgraph.connected_components(
            self._adjacency, directed=False)
        graphs = []
        for c in range(n_comp):
            idx = np.nonzero(labels == c)[0]
            G = self.subgraph(idx)
            G.info = {'orig_idx': idx}
            graphs.append(G)
        return graphs

    def subgraph(self, vertices):
        """The subgraph induced by ``vertices``, on this graph's device and
        dtype, with the coordinates and signals of those vertices.

        Examples
        --------
        >>> from pygsp_tpu_torch import graphs
        >>> G = graphs.Grid2d(4, 4, device='cpu')
        >>> H = G.subgraph([0, 1, 2, 3])     # the first row of the grid
        >>> H.N, H.Ne
        (4, 3)
        """
        vertices = np.asarray(vertices)
        adjacency = self._adjacency[vertices, :][:, vertices]
        try:
            coords = self.coords[vertices] if self.coords is not None else None
        except (TypeError, IndexError):
            coords = None
        G = Graph(adjacency, lap_type=self.lap_type, coords=coords,
                  plotting=self.plotting, device=self.device,
                  dtype=self.dtype)
        for name, signal in self.signals.items():
            G.set_signal(name, signal[vertices])
        return G

    def get_edge_list(self):
        """``(sources, targets, weights)`` as host arrays; the upper
        triangle only if the graph is undirected.

        Examples
        --------
        >>> from pygsp_tpu_torch import graphs
        >>> v_in, v_out, weights = graphs.Grid2d(1, 4, device='cpu').get_edge_list()
        >>> [v_in.tolist(), v_out.tolist()]
        [[0, 1, 2], [1, 2, 3]]
        """
        if self.is_directed():
            W = self._adjacency.tocoo()
        else:
            W = sps.triu(self._adjacency, format='coo')
        return W.row, W.col, W.data

    def set_coordinates(self, kind='spring', seed=None, **kwargs):
        """Set ``coords`` from an array (N, N×2 or N×3) or by the name of a
        layout (:func:`pygsp_tpu_torch.graphs._layout.set_coordinates`):
        ``'line1D'``, ``'line2D'``, ``'ring2D'``, ``'random2D'``,
        ``'random3D'``, ``'spring'`` (the default; ``kwargs`` go to it),
        ``'community2D'``, ``'laplacian_eigenmap2D'`` and
        ``'laplacian_eigenmap3D'``. The seeded layouts draw from NumPy's
        generator seeded with ``seed``, as in the JAX package.

        Examples
        --------
        >>> from pygsp_tpu_torch import graphs
        >>> G = graphs.Graph([[0, 1], [1, 0]], device='cpu')
        >>> G.set_coordinates('line2D')
        >>> G.coords.tolist()
        [[0.0, 0.0], [1.0, 0.0]]
        """
        from pygsp_tpu_torch.graphs import _layout
        _layout.set_coordinates(self, kind=kind, seed=seed, **kwargs)

    def plot(self, *args, **kwargs):
        """Draw the graph (:func:`pygsp_tpu_torch.plotting.plot_graph`)."""
        from pygsp_tpu_torch import plotting
        return plotting.plot_graph(self, *args, **kwargs)

    def plot_signal(self, signal, **kwargs):
        """Draw a signal as the vertices' colour."""
        from pygsp_tpu_torch import plotting
        return plotting.plot_graph(self, vertex_color=signal, **kwargs)

    def plot_spectrogram(self, **kwargs):
        """Draw the graph spectrogram
        (:func:`pygsp_tpu_torch.plotting.plot_spectrogram`)."""
        from pygsp_tpu_torch import plotting
        return plotting.plot_spectrogram(self, **kwargs)

    # ------------------------------------------------------------------
    # import and export (networkx, graph-tool, files)
    # ------------------------------------------------------------------

    def to_networkx(self):
        """The graph as a networkx (Di)Graph
        (:func:`pygsp_tpu_torch.graphs._io.to_networkx`)."""
        from pygsp_tpu_torch.graphs import _io
        return _io.to_networkx(self)

    @classmethod
    def from_networkx(cls, graph_nx, weight='weight', *, device='cuda',
                      dtype=torch.float32):
        """A Graph from a networkx graph, on ``device``."""
        from pygsp_tpu_torch.graphs import _io
        return _io.from_networkx(graph_nx, weight=weight, device=device,
                                 dtype=dtype)

    def to_graphtool(self):
        from pygsp_tpu_torch.graphs import _io
        return _io.to_graphtool(self)

    @classmethod
    def from_graphtool(cls, graph_gt, weight='weight', *, device='cuda',
                       dtype=torch.float32):
        from pygsp_tpu_torch.graphs import _io
        return _io.from_graphtool(graph_gt, weight=weight, device=device,
                                  dtype=dtype)

    def save(self, path, fmt=None, backend=None):
        """Save to GraphML, GML or GEXF
        (:func:`pygsp_tpu_torch.graphs._io.save`)."""
        from pygsp_tpu_torch.graphs import _io
        return _io.save(self, path, fmt=fmt, backend=backend)

    @classmethod
    def load(cls, path, fmt=None, backend=None, *, device='cuda',
             dtype=torch.float32):
        """A Graph read from GraphML, GML or GEXF, on ``device``."""
        from pygsp_tpu_torch.graphs import _io
        return _io.load(path, fmt=fmt, backend=backend, device=device,
                        dtype=dtype)

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------

    def _check_signal(self, s):
        if not isinstance(s, torch.Tensor):
            s = np.asanyarray(s)
        if s.ndim == 0 or s.shape[0] != self.n_vertices:
            raise ValueError(f'First dimension must be the number of vertices '
                             f'G.N = {self.N}, got {tuple(s.shape)}.')
        return s

    def set_signal(self, name: str, signal):
        self.signals[name] = self._check_signal(signal)

    # ------------------------------------------------------------------
    # degrees
    # ------------------------------------------------------------------

    @property
    def d(self):
        """Unweighted degree; directed = mean of in/out."""
        if self._d is None:
            if not self.is_directed():
                self._d = self._adjacency.getnnz(axis=1)
            else:
                din = self._adjacency.getnnz(axis=0)
                dout = self._adjacency.getnnz(axis=1)
                self._d = (din + dout) / 2
        return self._d

    @property
    def dw(self):
        """Weighted degree; directed = mean of in/out."""
        if self._dw is None:
            if not self.is_directed():
                self._dw = np.ravel(self._adjacency.sum(axis=0))
            else:
                din = np.ravel(self._adjacency.sum(axis=0))
                dout = np.ravel(self._adjacency.sum(axis=1))
                self._dw = (din + dout) / 2
        return self._dw

    # ------------------------------------------------------------------
    # Laplacian
    # ------------------------------------------------------------------

    def compute_laplacian(self, lap_type: str = 'combinatorial',
                          fmt: str = 'coo'):
        """(Re)build the Laplacian operator on ``device``.

        Directed graphs are average-symmetrized first; a change of
        Laplacian type drops the cached λmax. ``fmt='coo'`` stores the
        off-diagonal block as padded CSR, ``fmt='hybrid'`` in the
        multi-level ELL format
        (:class:`~pygsp_tpu_torch.core.sparse.ELLMatrix`), ``fmt='chunked'``
        in the chunked one
        (:mod:`pygsp_tpu_torch.core.chunked`), ``fmt='windowed'`` in the
        windowed-compact one (:mod:`pygsp_tpu_torch.core.windowed`), and
        ``fmt='auto'`` picks ``'windowed'`` above
        :data:`~pygsp_tpu_torch.core.chunked.CHUNK_ROWS` vertices and
        ``'hybrid'`` at or below, as the JAX package does. Use
        ``G.L.to_banded()`` for the banded format.
        """
        if getattr(self, 'lap_type', None) != lap_type:
            self._lmax = None
            self._lmax_method = None
            self._U = None
            self._e = None
            self._coherence = None
            self._D = None
        self.lap_type = lap_type

        if lap_type not in ('combinatorial', 'normalized'):
            raise ValueError(f'Unknown Laplacian type {lap_type!r}')

        W = self._adjacency
        if self.is_directed():
            W = utils.symmetrize(W, method='average')
        # Self-loop entries stay in the edge set: with diag = dw (which
        # includes loop weights) and off-diagonal values -w including the
        # diagonal COO entries, L_ii = dw_i - w_ii. The operator of the
        # requested type is built before the format is looked at, as in the
        # JAX package, so that a refused format leaves L of lap_type.
        Wsym = core_sparse.from_scipy(W, dtype=self.dtype, device=self.device)
        self._L = laplacian_op(Wsym, lap_type)
        if fmt == 'auto':
            fmt = 'windowed' if self.n_vertices > CHUNK_ROWS else 'hybrid'
        if fmt == 'hybrid':
            self._L = self._L.to_hybrid()
        elif fmt == 'chunked':
            self._L = self._L.to_chunked()
        elif fmt == 'windowed':
            self._L = self._L.to_windowed()
        elif fmt != 'coo':
            raise ValueError(f'Unknown Laplacian format {fmt!r}')
        self._Wsym_host = W

    @property
    def L(self) -> LaplacianOp:
        """Laplacian operator. Supports ``L @ x``, ``L.dot(x)``,
        ``L.to_scipy()``, ``L.to_dense()``, ``L.to_banded()``,
        ``L.to_hybrid()``, ``L.to_chunked()``, ``L.to_windowed()``."""
        return self._L

    def dirichlet_energy(self, x):
        """``x^T L x`` (per column for 2-D x)."""
        x = torch.as_tensor(self._check_signal(x), device=self.device)
        return torch.sum(x * matvec(self._L, x), dim=0)

    # ------------------------------------------------------------------
    # lmax
    # ------------------------------------------------------------------

    @property
    def lmax(self):
        """Largest-eigenvalue estimate; estimated on first use, with a
        warning."""
        if self._lmax is None:
            self.logger.warning(
                'The largest eigenvalue G.lmax is not available, we need to '
                'estimate it. Explicitly call G.estimate_lmax() once '
                'beforehand to suppress the warning.')
            self.estimate_lmax()
        return self._lmax

    def estimate_lmax(self, method: str = 'lanczos'):
        """Estimate λmax.

        'lanczos': fixed-order Lanczos ×1.01, clipped to the algebraic
        bound. 'bounds': min of four algebraic upper bounds.
        """
        if method == self._lmax_method:
            return
        if method == 'lanczos':
            lmax = float(ops_eigen.estimate_lmax_lanczos(self._L))
            self._lmax = min(lmax, float(self._get_upper_bound()))
        elif method == 'bounds':
            self._lmax = float(self._get_upper_bound())
        else:
            raise ValueError(f'Unknown method {method!r}')
        self._lmax_method = method

    def _get_upper_bound(self):
        if self.lap_type == 'normalized':
            return 2.0
        W = getattr(self, '_Wsym_host', self._adjacency)
        dw = np.ravel(W.sum(axis=0))
        bounds = [self.n_vertices * W.max() if W.nnz else 0.0,
                  2.0 * dw.max() if dw.size else 0.0]
        coo = W.tocoo()
        if coo.nnz:
            bounds.append(float(np.max(dw[coo.row] + dw[coo.col])))
            safe = np.where(dw > 0, dw, 1.0)
            m = W.dot(dw) / safe
            bounds.append(float(np.max(dw + m)))
        return min(bounds)

    # ------------------------------------------------------------------
    # Fourier basis (the exact spectral path; small graphs)
    # ------------------------------------------------------------------

    def compute_fourier_basis(self, n_eigenvectors=None):
        """Dense eigendecomposition of L on ``device``
        (:func:`~pygsp_tpu_torch.ops.eigen.fourier_basis`). The full basis
        also sets λmax to its largest eigenvalue and the coherence
        ``max |U|``.

        Examples
        --------
        >>> import torch
        >>> from pygsp_tpu_torch import graphs
        >>> G = graphs.Grid2d(3, 3, device='cpu', dtype=torch.float64)
        >>> G.compute_fourier_basis()
        >>> tuple(G.U.shape), float(G.e[0])
        ((9, 9), 0.0)
        """
        if n_eigenvectors is None:
            n_eigenvectors = self.n_vertices
        if self._U is not None and n_eigenvectors <= len(self._e):
            return
        if self.n_vertices ** 2 * n_eigenvectors > 3000 ** 3:
            self.logger.warning(
                'Computing the eigendecomposition of a large matrix is '
                'expensive. Consider using a polynomial filter instead.')
        e, U = ops_eigen.fourier_basis(self._L, n_eigenvectors)
        self._e, self._U = e, U
        if n_eigenvectors == self.N:
            self._lmax = float(e[-1])
            self._lmax_method = 'fourier'
            self._coherence = float(torch.max(torch.abs(U)))

    @property
    def U(self):
        """Fourier basis: the Laplacian's eigenvectors, by column."""
        return self._check_fourier('_U')

    @property
    def e(self):
        """The Laplacian's eigenvalues, ascending."""
        return self._check_fourier('_e')

    @property
    def coherence(self):
        """``max |U|``, the Fourier basis's coherence."""
        return self._check_fourier('_coherence')

    def _check_fourier(self, attr):
        if getattr(self, attr) is None:
            self.logger.warning(
                f'The Fourier basis G.{attr[1:]} is not available, we need '
                'to compute the Fourier basis. Explicitly call '
                'G.compute_fourier_basis() once beforehand to suppress the '
                'warning.')
            self.compute_fourier_basis()
        return getattr(self, attr)

    def gft(self, s):
        """Graph Fourier transform ``ŝ = Uᵀ s`` over the first axis; ``s``
        (numpy or tensor) is moved to the graph's device."""
        U = self.U
        s = torch.as_tensor(self._check_signal(s), device=U.device)
        dt = torch.promote_types(s.dtype, U.dtype)
        return torch.tensordot(U.conj().to(dt), s.to(dt), dims=([0], [0]))

    def igft(self, s_hat):
        """Inverse graph Fourier transform ``s = U ŝ`` over the first axis."""
        U = self.U
        s_hat = torch.as_tensor(s_hat, device=U.device)
        dt = torch.promote_types(s_hat.dtype, U.dtype)
        return torch.tensordot(U.to(dt), s_hat.to(dt), dims=([1], [0]))

    # ------------------------------------------------------------------
    # the difference operator: grad / div
    # ------------------------------------------------------------------

    def compute_differential_operator(self):
        """The edge-incidence operator D with ``L = D Dᵀ``, on ``device``:
        per edge ``±√w`` (combinatorial) or ``√(w/dw)`` at each end
        (normalized, dw of the symmetrized adjacency), divided by √2 on a
        directed graph, zero on a self-loop.

        Examples
        --------
        >>> import numpy as np, torch
        >>> from pygsp_tpu_torch import graphs
        >>> G = graphs.Grid2d(1, 5, device='cpu', dtype=torch.float64)
        >>> G.compute_differential_operator()
        >>> s = np.arange(5.)
        >>> tuple(G.grad(s).shape)    # one difference per edge
        (4,)
        >>> bool(torch.allclose(G.div(G.grad(s)), G.L @ torch.from_numpy(s)))
        True
        """
        sources, targets, weights = self.get_edge_list()
        w = np.asarray(weights, dtype=np.float64)
        if self.lap_type == 'combinatorial':
            v_src = -np.sqrt(w)
            v_tgt = np.sqrt(w)
        elif self.lap_type == 'normalized':
            dw = np.ravel(getattr(self, '_Wsym_host', self._adjacency).sum(axis=0))
            safe = np.where(dw > 0, dw, 1.0)
            v_src = -np.sqrt(w / safe[sources])
            v_tgt = np.sqrt(w / safe[targets])
        else:
            raise ValueError(f'Unknown lap_type {self.lap_type!r}')
        if self.is_directed():
            v_src = v_src / np.sqrt(2)
            v_tgt = v_tgt / np.sqrt(2)
        # a self-loop's row of D is zero (√w − √w on one vertex)
        loops = sources == targets
        v_src = np.where(loops, 0.0, v_src)
        v_tgt = np.where(loops, 0.0, v_tgt)
        self._D = _DifferenceOp(self.n_vertices, sources, targets, v_src,
                               v_tgt, device=self.device, dtype=self.dtype)

    @property
    def D(self):
        """The difference operator, computed on first use with a warning."""
        if self._D is None:
            self.logger.warning(
                'The differential operator G.D is not available, we need to '
                'compute it. Explicitly call G.compute_differential_operator() '
                'once beforehand to suppress the warning.')
            self.compute_differential_operator()
        return self._D

    def grad(self, x):
        """The gradient on the edges, ``Dᵀ x`` (one CSR SpMM)."""
        return self.D.grad(self._check_signal(x))

    def div(self, y):
        """The divergence on the vertices, ``D y`` (one CSR SpMM)."""
        return self.D.div(y)


class _DifferenceOp:
    """The edge-incidence operator D (N × Ne) on a device.

    Dᵀ is stored as a :class:`~pygsp_tpu_torch.core.sparse.CSRMatrix` of Ne
    rows with two entries each, ``(s_e, v_src[e])`` and ``(t_e, v_tgt[e])``,
    and D as its transpose (:attr:`CSRMatrix.T`), each vertex's entries in
    edge order. ``grad(x) = Dᵀ x`` and ``div(y) = D y`` are each one product
    on the CSR SpMM kernel, and each is the other's adjoint in autograd.
    Together they satisfy ``div(grad(x)) = L x``.
    """

    def __init__(self, n_vertices, sources, targets, v_src, v_tgt, *,
                 device='cuda', dtype=torch.float32):
        self.n_vertices = int(n_vertices)
        self.n_edges = len(sources)
        self.device = torch.device(device)
        np_dtype = torch.zeros(0, dtype=dtype).numpy().dtype
        cols = np.stack([sources, targets], axis=1).reshape(-1)
        vals = np.stack([v_src, v_tgt], axis=1).reshape(-1).astype(np_dtype)
        rows = np.repeat(np.arange(self.n_edges), 2)
        self.DT = core_sparse._pad_and_build(rows, cols, vals, self.n_edges,
                                             self.n_vertices,
                                             core_sparse.EDGE_BLOCK,
                                             self.device)
        self.D = self.DT.T

    def grad(self, x):
        """``(Dᵀ x)[e] = v_tgt[e] x[t_e] + v_src[e] x[s_e]``: (Ne, ...)."""
        return _Grad.apply(torch.as_tensor(x, device=self.device), self)

    def div(self, y):
        """``(D y)[v]``, the sum over the edges at v of their value times
        y: (N, ...)."""
        y = torch.as_tensor(y, device=self.device)
        if y.ndim == 0 or y.shape[0] != self.n_edges:
            raise ValueError(f'First dimension must be the number of edges '
                             f'G.Ne = {self.n_edges}, got {tuple(y.shape)}.')
        return _Div.apply(y, self)

    def to_scipy(self):
        """D as a scipy CSC matrix (N, Ne), without explicit zeros."""
        D = core_sparse.to_scipy(self.DT).T.tocsc()
        D.eliminate_zeros()
        return D

    def toarray(self):
        return self.to_scipy().toarray()

    @property
    def T(self):
        return _TransposedDiff(self)

    def dot(self, y):
        return self.div(y)


class _TransposedDiff:
    def __init__(self, D):
        self._D = D

    def dot(self, x):
        return self._D.grad(x)


class _Grad(torch.autograd.Function):
    """``Dᵀ x``; its backward is ``D ȳ``, on the same kernel."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return core_sparse.spmm(op.DT, x)

    @staticmethod
    def backward(ctx, gy):
        return _Div.apply(gy, ctx.op), None


class _Div(torch.autograd.Function):
    """``D y``; its backward is ``Dᵀ x̄``, on the same kernel."""

    @staticmethod
    def forward(ctx, y, op):
        ctx.op = op
        return core_sparse.spmm(op.D, y)

    @staticmethod
    def backward(ctx, gx):
        return _Grad.apply(gx, ctx.op), None
