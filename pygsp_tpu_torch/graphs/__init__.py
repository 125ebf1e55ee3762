"""Graph core and model zoo (counterpart of :mod:`pygsp_tpu.graphs`).

The model classes are exported lazily, as in the JAX package: each module
is imported on first use.
"""

from pygsp_tpu_torch.graphs.graph import Graph
from pygsp_tpu_torch.graphs.barabasialbert import ba_edges, ba_edges_fast

__all__ = ['Graph', 'ba_edges', 'ba_edges_fast']


_LAZY = {
    'Airfoil': 'airfoil', 'BarabasiAlbert': 'barabasialbert',
    'Comet': 'comet', 'Community': 'community',
    'DavidSensorNet': 'davidsensornet', 'ErdosRenyi': 'erdosrenyi',
    'FullConnected': 'fullconnected', 'Grid2d': 'grid2d',
    'LineGraph': 'linegraph', 'Logo': 'logo',
    'LowStretchTree': 'lowstretchtree', 'Minnesota': 'minnesota',
    'Path': 'path', 'RandomRegular': 'randomregular',
    'RandomRing': 'randomring', 'Ring': 'ring',
    'StochasticBlockModel': 'stochasticblockmodel', 'Star': 'star',
    'SwissRoll': 'swissroll', 'Torus': 'torus',
    # nearest-neighbour graphs
    'NNGraph': 'nngraphs.nngraph', 'Bunny': 'nngraphs.bunny',
    'Cube': 'nngraphs.cube', 'Grid2dImgPatches': 'nngraphs.grid2dimgpatches',
    'ImgPatches': 'nngraphs.imgpatches', 'Sensor': 'nngraphs.sensor',
    'Sphere': 'nngraphs.sphere', 'TwoMoons': 'nngraphs.twomoons',
}


def __getattr__(name):
    import importlib
    if name in _LAZY:
        mod = importlib.import_module(f'pygsp_tpu_torch.graphs.{_LAZY[name]}')
        cls = getattr(mod, name)
        globals()[name] = cls
        return cls
    # a submodule (``pygsp_tpu_torch.graphs.ring``), imported on demand
    try:
        mod = importlib.import_module(f'pygsp_tpu_torch.graphs.{name}')
    except ImportError:
        pass
    else:
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'pygsp_tpu_torch.graphs' has no attribute {name!r}")


def __dir__():
    """The lazy names as well, for dir() and tab completion."""
    return sorted(set(globals()) | set(_LAZY))
