"""The port's public surface against the JAX package's.

For every module of ``pygsp_tpu`` (its sub-packages included) the module of
the same name in ``pygsp_tpu_torch`` must exist and hold every public class
and function that the JAX module defines (a package: every one it
re-exports from ``pygsp_tpu``), and every public attribute of each class.
Each function, class and method takes the JAX package's parameters, in
order and of the same kind; after them the port may add keyword-only
``device``, ``dtype`` and ``generator``, and the few others named in
``PORT_ONLY``.

What is not ported yet stands in ``TO_PORT``, and a test holds each entry
there still missing, so the list shrinks as the modules land.
"""

import importlib
import inspect
import pkgutil

import pytest

import pygsp_tpu

# Modules and names of the JAX package still to port: none since the
# multi-device engines, the sharded checkpoints and the fused multi-matrix
# fold landed (ROADMAP §1 item 3, §2 item 4).
TO_PORT = ()

# A module that holds a Pallas kernel: its counterpart is the wrapper of
# the hand-written CUDA kernel (module, function) that replaces it.
REPLACED = {
    'pygsp_tpu.ops.pallas_banded': ('pygsp_tpu_torch.core.banded_kernel',
                                    'banded_spmm'),
}

# Keyword-only parameters the port adds to any function or class.
ANY_EXTRA = {'device', 'dtype', 'generator'}

# Other parameters the port adds after the JAX package's, by name.
PORT_ONLY = {
    # the narrow output of the bf16 modes (keyword-only)
    **{name: {'out_dtype'} for name in (
        'core.spmm', 'core.sparse.spmm', 'core.sparse.ell_spmm',
        'core.chunked.chunked_spmm', 'core.windowed.windowed_spmm')},
    # the kernels' slot tables and residue lists, fields with defaults
    # after the JAX package's
    **{name: {'table', 'residue'} for name in (
        'core.ELLMatrix', 'core.sparse.ELLMatrix',
        'core.ELLMatrix.__init__', 'core.sparse.ELLMatrix.__init__')},
    **{name: {'slot_cols', 'slot_vals', 'table', 'residue'} for name in (
        'core.ChunkedELLMatrix', 'core.chunked.ChunkedELLMatrix',
        'core.ChunkedELLMatrix.__init__',
        'core.chunked.ChunkedELLMatrix.__init__')},
    **{name: {'residue'} for name in (
        'core.WindowedELLMatrix', 'core.windowed.WindowedELLMatrix',
        'core.WindowedELLMatrix.__init__',
        'core.windowed.WindowedELLMatrix.__init__')},
}

MODULES = ['pygsp_tpu'] + sorted(
    m.name for m in pkgutil.walk_packages(pygsp_tpu.__path__, 'pygsp_tpu.'))


def _port_name(name):
    return 'pygsp_tpu_torch' + name[len('pygsp_tpu'):]


def _public(module):
    """The public classes and functions a JAX module defines, or, for a
    package, re-exports from the JAX package."""
    package = hasattr(module, '__path__')
    out = {}
    for name in dir(module):
        obj = getattr(module, name)
        if name.startswith('_') or not (inspect.isclass(obj)
                                        or inspect.isfunction(obj)):
            continue
        home = getattr(obj, '__module__', '') or ''
        if (home.startswith('pygsp_tpu.') if package
                else home == module.__name__):
            out[name] = obj
    return out


def _signature_gaps(qualname, want, got):
    """Where ``got``'s parameters depart from ``want``'s: the JAX ones in
    order and of the same kind, then only the allowed additions."""
    try:
        pw = list(inspect.signature(want).parameters.values())
        pg = list(inspect.signature(got).parameters.values())
    except (TypeError, ValueError):
        return []
    head = [(p.name, p.kind) for p in pg[:len(pw)]]
    if head != [(p.name, p.kind) for p in pw]:
        return [f'{qualname}{inspect.signature(got)} does not begin with '
                f'the JAX parameters {inspect.signature(want)}']
    allowed = PORT_ONLY.get(qualname, set())
    return [f'{qualname}: added parameter {p.name!r}' for p in pg[len(pw):]
            if p.name not in allowed and not (
                p.kind == p.KEYWORD_ONLY and p.name in ANY_EXTRA)]


@pytest.mark.parametrize('name', [m for m in MODULES if m not in TO_PORT])
def test_module_surface(name):
    jax_mod = importlib.import_module(name)
    if name in REPLACED:
        module, function = REPLACED[name]
        assert callable(getattr(importlib.import_module(module), function))
        return
    port = importlib.import_module(_port_name(name))
    short = name[len('pygsp_tpu.'):]
    gaps = []
    for attr, obj in _public(jax_mod).items():
        qual = f'{short}.{attr}'
        if f'{name}.{attr}' in TO_PORT:
            continue
        if not hasattr(port, attr):
            gaps.append(f'missing {qual}')
            continue
        ported = getattr(port, attr)
        gaps += _signature_gaps(qual, obj, ported)
        if not inspect.isclass(obj):
            continue
        for member in dir(obj):
            if member.startswith('_') and member != '__init__':
                continue
            owner = next(c for c in obj.__mro__ if member in vars(c))
            if f'{owner.__name__}.{member}' in TO_PORT:
                continue
            if not hasattr(ported, member):
                gaps.append(f'missing {qual}.{member}')
                continue
            want = inspect.getattr_static(obj, member)
            if inspect.isfunction(want) or isinstance(
                    want, (staticmethod, classmethod)):
                gaps += _signature_gaps(f'{qual}.{member}',
                                        getattr(obj, member),
                                        getattr(ported, member))
    assert not gaps, '\n'.join(gaps)


@pytest.mark.parametrize('cls', ['Graph', 'Filter'])
def test_graph_and_filter_attributes(cls):
    import pygsp_tpu_torch
    jax_cls = getattr(pygsp_tpu.graphs if cls == 'Graph'
                      else pygsp_tpu.filters, cls)
    port_cls = getattr(pygsp_tpu_torch.graphs if cls == 'Graph'
                       else pygsp_tpu_torch.filters, cls)
    missing = [n for n in dir(jax_cls) if not n.startswith('_')
               and not hasattr(port_cls, n) and f'{cls}.{n}' not in TO_PORT]
    assert not missing, f'{cls} lacks {missing}'


def test_still_to_port_is_still_missing():
    """Each entry of ``TO_PORT`` is indeed absent from the port: a slice
    that ports one removes it from the list."""
    for entry in TO_PORT:
        _check_missing(entry)


def _check_missing(entry):
    import pygsp_tpu_torch
    if entry.startswith('pygsp_tpu.'):
        parent, _, leaf = _port_name(entry).rpartition('.')
        try:
            module = importlib.import_module(parent)
        except ImportError:
            return
        if hasattr(module, leaf):
            pytest.fail(f'{entry} is ported: take it off TO_PORT')
        try:
            importlib.import_module(_port_name(entry))
        except ImportError:
            return
        pytest.fail(f'{entry} is ported: take it off TO_PORT')
    cls, _, member = entry.partition('.')
    owner = getattr(pygsp_tpu_torch.graphs if cls == 'Graph'
                    else pygsp_tpu_torch.filters, cls)
    assert not hasattr(owner, member), f'{entry} is ported: take it off'
