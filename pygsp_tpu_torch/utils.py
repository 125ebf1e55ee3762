"""Host-side utilities: logging, symmetrization, bundled assets.

Counterpart of :mod:`pygsp_tpu.utils` (the parts the ported modules need).
These run on host NumPy/SciPy: they build graphs, they are not compute-path
code. The assets are read from this package's own ``data/`` folder.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import scipy.sparse as sps
import torch

_DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')


def check_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a card and none
    is available, rather than let the caller run on the CPU unasked."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{caller}: no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return device


def to_numpy(x):
    """``x`` as a host NumPy array; a tensor is copied off its device.

    Examples
    --------
    >>> import torch
    >>> to_numpy(torch.arange(3))
    array([0, 1, 2])
    """
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_logger(name: str) -> logging.Logger:
    """Per-module logger writing to standard error."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '%(asctime)s:[%(levelname)s](%(name)s.%(funcName)s): %(message)s'))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def symmetrize(W, method: str = 'average'):
    """Symmetrize a square (sparse or dense) matrix.

    Methods: 'average', 'maximum', 'fill' (fill zeros from the transpose,
    average ambiguous entries), 'tril'/'triu' (keep one triangle, mirror it).

    Examples
    --------
    >>> import numpy as np
    >>> W = np.array([[0., 3.], [1., 0.]])
    >>> symmetrize(W, 'average')
    array([[0., 2.],
           [2., 0.]])
    """
    if W.shape[0] != W.shape[1]:
        raise ValueError('Matrix must be square.')
    issp = sps.issparse(W)
    if method == 'average':
        return (W + W.T) / 2
    if method == 'maximum':
        if issp:
            bigger = W.T > W
            return W - W.multiply(bigger) + W.T.multiply(bigger)
        return np.maximum(W, W.T)
    if method == 'fill':
        A = W > 0
        if issp:
            mask = (A + A.T) - A
            W = W + mask.multiply(W.T)
        else:
            mask = np.logical_xor(np.logical_or(A, A.T), A)
            W = W + mask * W.T
        return symmetrize(W, method='average')
    if method in ('tril', 'triu'):
        tri = getattr(sps if issp else np, method)
        return symmetrize(tri(W), method='maximum')
    raise ValueError(f'Unknown symmetrization method {method!r}')


def distanz(x, y=None):
    """Pairwise Euclidean distances between the columns of x and y.

    x, y: (d, Nx), (d, Ny) (1-D inputs are promoted to one row); returns
    (Nx, Ny).

    Examples
    --------
    >>> import numpy as np
    >>> distanz(np.arange(3))
    array([[0., 1., 2.],
           [1., 0., 1.],
           [2., 1., 0.]])
    """
    x = np.asarray(x, dtype=float)
    x = x.reshape(1, -1) if x.ndim == 1 else x
    y = x if y is None else np.asarray(y, dtype=float)
    y = y.reshape(1, -1) if y.ndim == 1 else y
    if x.shape[0] != y.shape[0]:
        raise ValueError('The sizes of x and y do not fit')
    xx = np.sum(x * x, axis=0)
    yy = np.sum(y * y, axis=0)
    d2 = np.abs(xx[:, None] + yy[None, :] - 2.0 * (x.T @ y))
    return np.sqrt(d2)


def resistance_distance(G):
    """The resistance-distance matrix, as a scipy CSC matrix, from a Graph
    with a combinatorial Laplacian or from a sparse Laplacian.

    It takes the dense pseudo-inverse of L on the host
    (``numpy.linalg.pinv``, a Graph's Laplacian in float64): small graphs
    only. The sparsifiers estimate
    the resistances of large graphs by sketching instead
    (:func:`pygsp_tpu_torch.reduction.effective_resistances_sketch`).

    Examples
    --------
    >>> import scipy.sparse as sps
    >>> L = sps.csc_matrix([[1., -1., 0.], [-1., 2., -1.], [0., -1., 1.]])
    >>> resistance_distance(L).toarray().round(6)     # a path of 3
    array([[0., 1., 2.],
           [1., 0., 1.],
           [2., 1., 0.]])
    """
    if sps.issparse(G):
        L = G.tocsc()
    else:
        if G.lap_type != 'combinatorial':
            raise ValueError('Need a combinatorial Laplacian.')
        L = sps.csc_matrix(G.L.to_scipy(), dtype=np.float64)
    pseudo = np.linalg.pinv(L.toarray())
    d = np.diagonal(pseudo)
    rd = d[:, None] + d[None, :] - pseudo - pseudo.T
    return sps.csc_matrix(rd)


def rescale_center(x):
    """Center point-cloud coordinates x (d, N) and scale them into [-1, 1].

    Examples
    --------
    >>> import numpy as np
    >>> rescale_center(np.array([[0.0, 2.0, 4.0]]))
    array([[-1.,  0.,  1.]])
    """
    x = np.asarray(x, dtype=float)
    n = x.shape[1]
    y = x - np.kron(np.ones((1, n)), np.mean(x, axis=1)[:, None])
    c = np.amax(np.abs(y))
    return y / c


def compute_log_scales(lmin: float, lmax: float, n_scales: int,
                       t1: float = 1.0, t2: float = 2.0):
    """Log-spaced wavelet scales between heuristic bounds: they span
    [t1/lmax, t2/lmin] geometrically, largest first.

    Examples
    --------
    >>> compute_log_scales(1.0, 10.0, 3)
    array([2.       , 0.4472136, 0.1      ])
    """
    scale_min = t1 / lmax
    scale_max = t2 / lmin
    return np.exp(np.linspace(np.log(scale_max), np.log(scale_min), n_scales))


def loadmat(name: str) -> dict:
    """Load a bundled point-cloud/graph asset (``data/pointclouds/*.npz``).

    Sparse matrices are stored as ``<key>__sparse_{data,row,col,shape}``
    entries and come back as scipy CSC matrices.
    """
    if name.startswith('pointclouds/'):
        name = name[len('pointclouds/'):]
    path = os.path.join(_DATA_DIR, 'pointclouds', name + '.npz')
    with np.load(path, allow_pickle=False) as data:
        raw = {k: data[k] for k in data.files}
    out = {}
    for key, value in raw.items():
        if '__sparse_' in key:
            base, part = key.split('__sparse_')
            if base in out or part != 'row':
                continue
            out[base] = sps.csc_matrix(
                (raw[f'{base}__sparse_data'],
                 (raw[f'{base}__sparse_row'], raw[f'{base}__sparse_col'])),
                shape=tuple(raw[f'{base}__sparse_shape']))
        else:
            out[key] = value
    return out


def filterbank_handler(func):
    """Map a per-kernel function ``func(f, ..., i=k)`` over a filter bank:
    one result for a bank of one kernel or when ``i`` is given, else the
    list of the results for each of the bank's kernels."""
    @functools.wraps(func)
    def wrapper(f, *args, **kwargs):
        if 'i' in kwargs:
            return func(f, *args, **kwargs)
        n = f.n_filters if hasattr(f, 'n_filters') else len(f.g)
        if n <= 1:
            return func(f, *args, i=0, **kwargs)
        return [func(f, *args, i=i, **kwargs) for i in range(n)]
    return wrapper
