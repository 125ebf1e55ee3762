"""Spectral filter banks: ``Filter``, ``Heat`` and the filter zoo, and the
free functions of :mod:`.approximations`, loaded on first use."""

import importlib

from pygsp_tpu_torch.filters.filter import Filter
from pygsp_tpu_torch.filters.heat import Heat

__all__ = ['Filter', 'Heat']


_LAZY = {
    'Abspline': 'abspline', 'Expwin': 'expwin', 'Gabor': 'gabor',
    'HalfCosine': 'halfcosine', 'Held': 'held', 'Itersine': 'itersine',
    'MexicanHat': 'mexicanhat', 'Meyer': 'meyer', 'Modulation': 'modulation',
    'Papadakis': 'papadakis', 'Rectangular': 'rectangular',
    'Regular': 'regular', 'Simoncelli': 'simoncelli',
    'SimpleTight': 'simpletight', 'Wave': 'wave',
}

_APPROX_NAMES = ('compute_cheby_coeff', 'compute_jackson_cheby_coeff',
                 'cheby_op', 'cheby_rect', 'lanczos', 'lanczos_op')


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f'pygsp_tpu_torch.filters.{_LAZY[name]}')
        cls = getattr(mod, name)
        globals()[name] = cls
        return cls
    if name in _APPROX_NAMES:
        from pygsp_tpu_torch.filters import approximations
        fn = getattr(approximations, name)
        globals()[name] = fn
        return fn
    # a submodule (``pygsp_tpu_torch.filters.heat``), imported on demand
    try:
        mod = importlib.import_module(f'pygsp_tpu_torch.filters.{name}')
    except ImportError:
        pass
    else:
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'pygsp_tpu_torch.filters' has no attribute {name!r}")


def __dir__():
    """The lazy names as well, for dir() and tab completion."""
    return sorted(set(globals()) | set(_LAZY) | set(_APPROX_NAMES))
