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
(``Filter.filter(fixed_graph=True)``), exact and Lanczos filtering, the
graph zoo with the nearest-neighbour graphs, layouts and graph I/O, and the
algorithms: ``reduction``, ``learning``, ``features`` and ``optimization``,
with ``plotting`` (matplotlib, an optional dependency), imported on first
use as in the JAX package; and the auxiliaries ``checkpoint`` and
``profiling``. On a CSR operator ``ops.cheby_op`` differentiates through
the graph's weights.
"""

from pygsp_tpu_torch import core
from pygsp_tpu_torch import ops
from pygsp_tpu_torch import graphs
from pygsp_tpu_torch import filters
from pygsp_tpu_torch import utils

__version__ = '0.1.0'

__all__ = ['core', 'ops', 'graphs', 'filters', 'utils', 'reduction',
           'learning', 'features', 'optimization', 'plotting']


def __getattr__(name):
    # the algorithm modules and plotting, imported on first use
    if name in ('reduction', 'learning', 'features', 'optimization',
                'plotting'):
        import importlib
        module = importlib.import_module(f'pygsp_tpu_torch.{name}')
        globals()[name] = module
        return module
    raise AttributeError(f"module 'pygsp_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
