"""Convex optimization on graphs (counterpart of
:mod:`pygsp_tpu.optimization`).

``prox_tv`` is the JAX package's dual projected gradient on the graph's
difference operator: each iteration one ``div`` and one ``grad``
(:meth:`Graph.div`, :meth:`Graph.grad`), each one CSR SpMM kernel launch on
the card, and one more ``div`` at the end. The loop reads its stopping
value on the host once an iteration (the JAX package runs a
``lax.while_loop`` on the device) and stops at the same iteration.
"""

from __future__ import annotations

import torch

from pygsp_tpu_torch import utils

logger = utils.build_logger(__name__)


def prox_tv(x, gamma, G, A=None, At=None, nu=1, tol=1e-4, maxit=200,
            use_matrix=None):
    r"""Total-variation proximal operator:
    ``argmin_z ½‖x − z‖² + γ ‖∇_G z‖₁``.

    Solved in the dual: ``z = x − At(div(p))`` with the dual variable ``p``
    (one value per edge) held in ``[−γ, γ]``, updated by projected gradient
    ascent with step ``1/(2·λmax·ν)``, for at most ``maxit`` iterations,
    until the objective's relative change falls below ``tol``. ``x`` is
    moved to the graph's device and dtype; the result is a tensor there.
    ``A`` and ``At`` (default the identity) are an operator and its
    adjoint applied to z; ``use_matrix`` is accepted and ignored.

    Examples
    --------
    >>> import numpy as np, torch
    >>> from pygsp_tpu_torch import graphs, optimization
    >>> G = graphs.Sensor(64, seed=42, device='cpu', dtype=torch.float64)
    >>> G.compute_differential_operator()
    >>> G.estimate_lmax()
    >>> x = np.random.default_rng(0).normal(size=64)
    >>> y = optimization.prox_tv(x, gamma=3.0, G=G)
    >>> bool(y.var() < np.var(x))         # the prox smooths along edges
    True
    """
    if A is None:
        A = lambda z: z  # noqa: E731
    if At is None:
        At = lambda z: z  # noqa: E731

    x = torch.as_tensor(x, device=G.device).to(G.dtype)
    if G._D is None:
        G.compute_differential_operator()
    D = G.D

    step = 1.0 / (2.0 * G.lmax * nu)

    p = torch.zeros((G.n_edges,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    inf = torch.tensor(float('inf'), dtype=x.dtype, device=x.device)
    obj_prev, rel, it = inf, inf, 0
    while it < maxit and bool(rel >= tol):
        z = x - At(D.div(p))
        grad_z = D.grad(A(z))
        # project onto the ∞-ball of radius gamma (elementwise clamp)
        p = torch.clamp(p + step * grad_z, -gamma, gamma)
        obj = 0.5 * torch.sum((x - z) ** 2) + gamma * torch.sum(
            torch.abs(grad_z))
        rel = torch.abs(obj - obj_prev) / torch.clamp(torch.abs(obj),
                                                      min=1e-30)
        obj_prev = obj
        it += 1

    return x - At(D.div(p))
