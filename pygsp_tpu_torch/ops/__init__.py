"""Compute paths: SpMM, Chebyshev recurrence, Lanczos, the spectrum
(λmax, the Fourier basis, LOBPCG), conjugate gradients."""

from pygsp_tpu_torch.ops.spmm import spmm
from pygsp_tpu_torch.ops.chebyshev import (carry_error_estimate, cheby_coeff,
                                           cheby_op, cheby_op_fixed_graph,
                                           cheby_op_intermediates,
                                           cheby_rect, cheby_synthesis,
                                           jackson_cheby_coeff)
from pygsp_tpu_torch.ops.eigen import (estimate_lmax_bounds,
                                       estimate_lmax_lanczos, fourier_basis,
                                       laplacian_upper_bound,
                                       partial_fourier_basis,
                                       power_iteration_lmax)
from pygsp_tpu_torch.ops.lanczos import lanczos_basis, lanczos_op
from pygsp_tpu_torch.ops.lobpcg import lobpcg_standard

__all__ = [
    'spmm',
    'carry_error_estimate',
    'cheby_coeff', 'cheby_op', 'cheby_op_fixed_graph',
    'cheby_op_intermediates', 'cheby_rect',
    'cheby_synthesis', 'jackson_cheby_coeff',
    'estimate_lmax_lanczos', 'estimate_lmax_bounds', 'fourier_basis',
    'laplacian_upper_bound', 'partial_fourier_basis', 'power_iteration_lmax',
    'lanczos_basis', 'lanczos_op', 'lobpcg_standard',
]
