"""pygsp_tpu_torch — spectral graph signal processing in PyTorch and CUDA.

The port of :mod:`pygsp_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports neither JAX nor ``pygsp_tpu``. Public names and module layout
follow the JAX package: ``pygsp_tpu_torch.graphs``, ``.filters``, ``.ops``,
``.core``, ``.utils``. Operators live on ``device='cuda'`` unless the
caller asks for the CPU; the SpMMs run hand-written CUDA kernels
(``csrc/``) on the card and their plain PyTorch versions on the CPU.

The slices so far cover the Chebyshev heat-filtering path (``Graph`` with
its Laplacian and λmax, ``Grid2d``, ``BarabasiAlbert``, ``Logo``,
``Filter`` and ``Heat``, on the CSR, block-banded and windowed-compact
storage formats), training through the constant-memory fixed-graph VJP
(``Filter.filter(fixed_graph=True)``), and exact and Lanczos filtering.
"""

from pygsp_tpu_torch import core
from pygsp_tpu_torch import ops
from pygsp_tpu_torch import graphs
from pygsp_tpu_torch import filters
from pygsp_tpu_torch import utils

__version__ = '0.1.0'

__all__ = ['core', 'ops', 'graphs', 'filters', 'utils']
