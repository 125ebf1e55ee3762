"""The recurrence, synthesis, Lanczos and the fixed-graph VJP on the port's
chunked format against pygsp_tpu, in float64 on the CPU: within 1e-12,
λmax pinned, on a ragged last chunk and under the degree permutation.

The JAX package compiles its chunked scan once per block, which makes this
the slowest of the chunked tests; it lives apart from the format's own
tests (tests/test_torch_chunked.py) so that the two run side by side.
"""

import pytest

from test_torch_ell import _graphs, check_recurrence


@pytest.mark.parametrize('kw', [dict(chunk_rows=256),
                                dict(chunk_rows=200, permute='degree')],
                         ids=['R256-ragged', 'R200-degree'])
@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_recurrence_and_vjp_match_jax(lap_type, kw):
    J, T = _graphs('chunked', lap_type, **kw)
    assert (T.L.offdiag.perm is not None) == ('permute' in kw)
    check_recurrence(J, T, seed=3)
