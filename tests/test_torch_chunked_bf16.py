"""The port's chunked bf16 modes on the CPU: held against the float64
recurrence of pygsp_tpu within ``carry_error_estimate``, never against the
JAX package's chunked bf16 output, which sums its rows in bf16 (ROADMAP.md
§3, caveat 1); and the carry gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygsp_tpu.ops import chebyshev as jcheby
from pygsp_tpu_torch.ops import chebyshev as tcheby

from test_torch_ell import _graphs, _heat

MODES = {'carry': ('carry_dtype',), 'vals': ('vals_dtype',),
         'both': ('carry_dtype', 'vals_dtype')}


@pytest.mark.parametrize('mode', list(MODES))
def test_bf16_modes_within_the_carry_estimate(mode):
    """The port's chunked bf16 modes sum their rows in float32: held to the
    float64 recurrence within carry_error_estimate, not to the JAX
    package's chunked bf16 output (which sums in bf16)."""
    J, T = _graphs('chunked', chunk_rows=128)
    lmax = J.lmax
    c = _heat(lmax, (5.0, 10.0, 25.0, 50.0))
    x = np.random.default_rng(11).normal(size=(T.N, 4))
    ref = np.asarray(jcheby.cheby_op(J.L, lmax, jnp.asarray(c),
                                     jnp.asarray(x)))
    got = tcheby.cheby_op(T.L.astype(torch.float32), lmax,
                          torch.from_numpy(c).float(),
                          torch.from_numpy(x).float(),
                          **{k: torch.bfloat16 for k in MODES[mode]})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    est = tcheby.carry_error_estimate(c, torch.bfloat16)
    assert float(np.abs(got.double().numpy() - ref).max()) <= (
        1.5 * est * float(np.abs(ref).max()))


def test_chunked_takes_the_modes_under_the_gate():
    J, T = _graphs('chunked', chunk_rows=64)
    c = torch.from_numpy(_heat(J.lmax, m=6))
    x = torch.zeros(T.N, 2, dtype=torch.float64)
    with pytest.raises(ValueError) as terr:
        tcheby.cheby_op(T.L, J.lmax, c, x.float(), carry_dtype=torch.bfloat16,
                        carry_tol=1e-9)
    assert 'carry_dtype=bfloat16 refused' in str(terr.value)
    out = tcheby.cheby_op(T.L, J.lmax, c, x, vals_dtype=torch.bfloat16)
    assert out.dtype == torch.float64 and not out.abs().max()
