"""The bf16 fast mode's error in both packages, on the CPU.

Runs the heat bank of ``bench.py`` (scales 5, 10, 25 and 50, order 30) on
a Barabási–Albert graph (``ba_edges_fast(n, m0=8, m=8, seed=42)``, the
windowed format, λmax pinned) for 8 columns of a numpy signal from a seed,
three ways: the JAX package in float64 (the reference), the JAX package in
the fast mode (``carry_dtype`` and ``vals_dtype`` bfloat16 on a float32
operator) and the port in the same mode on its plain versions. Prints one
JSON line: each mode's error against the reference, over all filters and
per filter, relative to the largest reference value, beside
``carry_error_estimate``. It shows whether an error of the port's fast
mode on the card is the mode's own or the port's.

Run: ``JAX_PLATFORMS=cpu python3 tools/fast_mode_parity.py [--log2n 20]
[--lmax 6664.618803]`` (the default λmax is the one ``chip_smoke.py``'s
path C estimates at N = 2^20; at 2^20 the run takes about 5 minutes and a
few GB of host memory).
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pygsp_tpu as jgsp  # noqa: E402
import pygsp_tpu_torch as tgsp  # noqa: E402
from pygsp_tpu.core.operators import LaplacianOp  # noqa: E402
from pygsp_tpu_torch.ops.chebyshev import (carry_error_estimate,  # noqa: E402
                                           cheby_coeff)

SCALES = [5.0, 10.0, 25.0, 50.0]


def errors(out, ref):
    top = np.abs(ref).max()
    return {'all': float(np.abs(out - ref).max() / top),
            'per_filter': [float(np.abs(out[..., f] - ref[..., f]).max()
                                 / np.abs(ref[..., f]).max())
                           for f in range(ref.shape[-1])]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--log2n', type=int, default=20)
    parser.add_argument('--lmax', type=float, default=6664.618803)
    args = parser.parse_args()
    jax.config.update('jax_enable_x64', True)
    n = 1 << args.log2n
    src, tgt = tgsp.graphs.ba_edges_fast(n, m0=8, m=8, seed=42)
    W = sps.csr_matrix((np.ones(2 * len(src)),
                        (np.r_[src, tgt], np.r_[tgt, src])), shape=(n, n))
    W.data[:] = 1.0
    x = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    J = jgsp.graphs.Graph(W)
    J.compute_laplacian(fmt='windowed')
    J._lmax = args.lmax
    ref = np.asarray(jgsp.filters.Heat(J, SCALES).filter(
        x.astype(np.float64), order=30))
    J._L = LaplacianOp(offdiag=J.L.offdiag.astype(jnp.float32),
                       diag=J.L.diag.astype(jnp.float32),
                       lap_type=J.L.lap_type)
    jout = np.asarray(jgsp.filters.Heat(J, SCALES).filter(
        x, order=30, carry_dtype=jnp.bfloat16, vals_dtype=jnp.bfloat16))
    del J
    T = tgsp.graphs.Graph(W, device='cpu')
    T.compute_laplacian(fmt='windowed')
    T._lmax, T._lmax_method = args.lmax, 'pinned'
    g = tgsp.filters.Heat(T, SCALES)
    tout = g.filter(torch.from_numpy(x), order=30,
                    carry_dtype=torch.bfloat16,
                    vals_dtype=torch.bfloat16).numpy()
    c = cheby_coeff(g.evaluate, args.lmax, m=30, device='cpu')
    print(json.dumps({
        'n': n, 'lmax': args.lmax,
        'carry_error_estimate': carry_error_estimate(c, torch.bfloat16),
        'jax_fast_mode': errors(jout, ref),
        'port_fast_mode': errors(tout, ref),
        'port_vs_jax_all': float(np.abs(tout - jout).max()
                                 / np.abs(ref).max()),
        'max_abs_x': float(np.abs(x).max())}), flush=True)


if __name__ == '__main__':
    main()
