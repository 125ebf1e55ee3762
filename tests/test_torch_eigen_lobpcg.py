"""``partial_fourier_basis`` (LOBPCG) run to convergence and on a float32
operator, against SciPy's ``eigsh``, in float64 on the CPU: held as
tests/test_torch_eigen.py holds it (its fixture and tolerances). They
take about as long as the rest of that file, so they run beside it.
"""

import numpy as np
import torch

import pygsp_tpu_torch as tgsp
from pygsp_tpu_torch.ops import eigen as teigen

from test_torch_eigen import K, LOBPCG_GRID, _held, lobpcg_graphs  # noqa: F401


def test_partial_fourier_basis_runs_to_convergence(lobpcg_graphs):
    """The JAX package's cap of 300 iterations stops LOBPCG short on this
    grid, which needs about 612 at k = 4; the port's cap of 3000 lets it
    converge, to the eigenvalues of eigsh within 1e-10."""
    _, T, er, _ = lobpcg_graphs
    e, _ = teigen.partial_fourier_basis(T.L, K)
    e300, _ = teigen.partial_fourier_basis(T.L, K, maxiter=300)
    assert np.abs(e.numpy() - er).max() <= 1e-10
    assert np.abs(e300.numpy() - er).max() > 1e-10


def test_partial_fourier_basis_of_a_float32_operator(lobpcg_graphs):
    """A float32 operator (the graphs' default) is solved in float64 and
    cast back: held as the f64 path is. Kept in float32, LOBPCG's stopping
    rule holds at once on this grid and the eigenvalues come out about
    1.5e-2 off."""
    _, _, er, Ur = lobpcg_graphs
    T = tgsp.graphs.Grid2d(*LOBPCG_GRID, device='cpu')
    assert T.L.dtype == torch.float32
    e, U = teigen.partial_fourier_basis(T.L, K)
    assert e.dtype == U.dtype == torch.float32
    _held(e, U.double(), er, Ur)
    T.set_coordinates('laplacian_eigenmap2D')
    assert np.abs(T.e.numpy() - er[:3]).max() <= 1e-6
    assert np.abs(np.abs(np.einsum('ij,ij->j', T.coords,
                                   Ur[:, 1:3])) - 1).max() <= 1e-4
