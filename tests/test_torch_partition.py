"""The port's partitioners, local layouts, launch helpers and sharded
checkpoints against the JAX package's, and its engines at one rank.

Every host array the port's ``partition_graph`` (three ``reorder``
values), ``cluster_shards``, ``shard_local_ell`` and
``shard_local_windowed`` (whole and split), ``partition_graph_2d`` and
``twod_local_windowed`` (plain, ring, ring with ``split_cols``, mono, and
mono with ``split_cols``) build equals the JAX package's on
``Sensor(200, seed=7)`` and ``StochasticBlockModel(N=192, k=3, seed=0)``.
The sharded checkpoint loads both ways; a one-rank mesh runs every layout
with no process group, within 1e-12 of the JAX package's single-device
bank.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import pygsp_tpu as gsp
from pygsp_tpu import checkpoint as jckpt
from pygsp_tpu import parallel as jpar
from pygsp_tpu.ops import chebyshev as jcheby

from pygsp_tpu_torch import checkpoint as tckpt
from pygsp_tpu_torch import parallel as tpar
from pygsp_tpu_torch.parallel import partition as tpart

GRAPHS = {'sensor': lambda: gsp.graphs.Sensor(200, seed=7),
          'sbm': lambda: gsp.graphs.StochasticBlockModel(N=192, k=3,
                                                          seed=0)}


@pytest.fixture(scope='module', params=sorted(GRAPHS))
def W(request):
    return sps.csr_matrix(GRAPHS[request.param]().W)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def assert_same(jax_obj, port_obj):
    """Every field of the JAX package's dataclass equals the port's: arrays
    (dtype widened: the port keeps uint16 row ids as int32) and ints."""
    for f in dataclasses.fields(jax_obj):
        a, b = getattr(jax_obj, f.name), getattr(port_obj, f.name)
        if isinstance(a, tuple):
            assert len(a) == len(b), f.name
            for u, v in zip(a, b):
                if isinstance(u, (int, np.integer)):
                    assert u == v, f.name
                else:
                    assert np.array_equal(_np(u), _np(v)), f.name
        elif isinstance(a, (int, str, np.integer)):
            assert a == b, f.name
        else:
            assert np.array_equal(_np(a).astype(np.float64),
                                  _np(b).astype(np.float64)), f.name


@pytest.mark.parametrize('reorder', ['rcm', 'none', 'cluster'])
@pytest.mark.parametrize('lap_type', ['combinatorial', 'normalized'])
def test_partition_graph_arrays(W, reorder, lap_type):
    a = jpar.partition_graph(W, 4, lap_type=lap_type, reorder=reorder,
                             dtype=np.float64)
    b = tpar.partition_graph(W, 4, lap_type=lap_type, reorder=reorder,
                             dtype=np.float64, device='cpu')
    assert_same(a, b)


def test_partition_balance_and_cluster_shards(W):
    assert np.array_equal(jpar.cluster_shards(W, 4),
                          tpar.cluster_shards(W, 4))
    a = jpar.partition_graph(W, 3, balance='vertex', dtype=np.float64)
    b = tpar.partition_graph(W, 3, balance='vertex', dtype=np.float64,
                             device='cpu')
    assert_same(a, b)
    assert b.dtype == torch.float64
    assert tpar.partition_graph(W, 2, device='cpu').dtype == torch.float32
    with pytest.raises(ValueError, match='reorder'):
        tpar.partition_graph(W, 2, reorder='bogus', device='cpu')
    with pytest.raises(ValueError, match='balance'):
        tpar.partition_graph(W, 2, balance='bogus', device='cpu')


@pytest.mark.parametrize('split', [False, True])
def test_shard_local_layouts(W, split):
    a = jpar.partition_graph(W, 4, dtype=np.float64)
    b = tpar.partition_graph(W, 4, dtype=np.float64, device='cpu')
    for jl, tl in ((jpar.shard_local_ell(a, split_boundary=split),
                    tpar.shard_local_ell(b, split_boundary=split)),
                   (jpar.shard_local_windowed(a, split_boundary=split),
                    tpar.shard_local_windowed(b, split_boundary=split))):
        for u, v in zip(jl if split else (jl,), tl if split else (tl,)):
            assert_same(u, v)


@pytest.mark.parametrize('kw', [
    dict(), dict(ring=True), dict(ring=True, split_cols=True),
    dict(ring=True, mono=True, chunk_rows=8, window_rows=8),
    dict(ring=True, mono=True, split_cols=True, chunk_rows=8,
         window_rows=8)], ids=['plain', 'ring', 'ring-split', 'mono',
                               'mono-split'])
def test_twod_partition_and_layouts(W, kw):
    a = jpar.partition_graph_2d(W, 2, 2, dtype=np.float64)
    b = tpar.partition_graph_2d(W, 2, 2, dtype=np.float64, device='cpu')
    assert_same(a, b)
    assert b.comm_rows_per_step == a.comm_rows_per_step
    ja = jpar.twod_local_windowed(a, **kw)
    tb = tpar.twod_local_windowed(b, **kw)

    def flat(t):
        return [u for v in t for u in flat(v)] if isinstance(t, tuple) \
            else [t]

    fa, fb = flat(ja), flat(tb)
    assert len(fa) == len(fb)
    for u, v in zip(fa, fb):
        assert_same(u, v)


@pytest.mark.parametrize('reorder', ['none', 'rcm', 'cluster'])
def test_twod_reorders(W, reorder):
    assert_same(jpar.partition_graph_2d(W, 4, 1, reorder=reorder,
                                        dtype=np.float64),
                tpar.partition_graph_2d(W, 4, 1, reorder=reorder,
                                        dtype=np.float64, device='cpu'))


def test_signal_padding_and_put(W):
    sg = tpar.partition_graph(W, 4, dtype=np.float64, device='cpu')
    x = np.random.default_rng(0).normal(size=(W.shape[0], 3))
    xp = sg.pad_signal(x)
    assert xp.shape == (sg.n_padded, 3)
    assert np.array_equal(sg.unpad_signal(xp).numpy(), x)
    ja = jpar.partition_graph(W, 4, dtype=np.float64)
    assert np.array_equal(np.asarray(ja.pad_signal(x)), xp.numpy())
    mesh = tpar.make_mesh(1, 1, devices='cpu')
    one = tpar.partition_graph(W, 1, dtype=np.float64, device='cpu')
    put = tpar.put_sharded_graph(one, mesh)
    assert put.rows.shape == one.rows.shape and put.perm.shape == (W.shape[0],)
    part = tpart.shard_slice(sg, 2)
    assert part.rows.shape[0] == 1 and torch.equal(part.rows[0], sg.rows[2])
    assert torch.equal(part.perm, sg.perm)


def test_sharded_checkpoint_both_ways(W, tmp_path):
    """A partition saved by either package loads in the other, array for
    array."""
    ja = jpar.partition_graph(W, 4, dtype=np.float64)
    tb = tpar.partition_graph(W, 4, dtype=np.float64, device='cpu')
    jckpt.save_sharded(str(tmp_path / 'j'), ja)
    tckpt.save_sharded(str(tmp_path / 't'), tb)
    assert_same(ja, tckpt.load_sharded(str(tmp_path / 'j'), device='cpu'))
    assert_same(jckpt.load_sharded(str(tmp_path / 't')), tb)
    mesh = tpar.make_mesh(1, 1, devices='cpu')
    one = tpar.put_sharded_graph(
        tpar.partition_graph(W, 1, device='cpu'), mesh)
    tckpt.save_sharded(str(tmp_path / 'one'), one)
    with pytest.raises(ValueError, match='shards'):
        tckpt.save_sharded(str(tmp_path / 'x'),
                           tpar.put_sharded_graph(tb, _mesh_of_four()))


def _mesh_of_four():
    """A stand-in for one rank's view of a 4-rank graph axis."""
    mesh = tpar.make_mesh(1, 1, devices='cpu')
    mesh.shape = {'graph': 4, 'batch': 1}
    mesh.coords = (1, 0)
    return mesh


def test_launch_helpers(tmp_path):
    """No process group: one process owns every item and every edge;
    initialize is a no-op without an address or more processes."""
    tpar.initialize()
    assert tpar.process_shard_range(10) == jpar.process_shard_range(10)
    assert tpar.process_shard_range(10) == (0, 10)
    src, tgt = np.array([0, 1, 2]), np.array([1, 2, 0])
    np.savez(tmp_path / 'e.npz', src=src, tgt=tgt)
    for got, want in zip(tpar.load_edge_shard(str(tmp_path / 'e.npz'), 3),
                         jpar.load_edge_shard(str(tmp_path / 'e.npz'), 3)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    mesh = tpar.global_mesh(device='cpu')
    assert mesh.shape == {'graph': 1, 'batch': 1} and mesh.coords == (0, 0)
    with pytest.raises(ValueError, match='ranks'):
        tpar.global_mesh(2, device='cpu')
    with pytest.raises(ValueError, match='processes'):
        tpar.make_mesh(2, 1, devices='cpu')


@pytest.fixture(scope='module')
def one_rank(W):
    """The single-device bank and synthesis on the JAX package's graph, and
    the one-partition problem."""
    G = gsp.graphs.Graph(W)
    Ls = sps.diags(np.ravel(W.sum(axis=1))) - W
    lmax = 1.01 * float(sps.linalg.eigsh(Ls, k=1, which='LA')[0][0])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(W.shape[0], 3))
    c = rng.normal(size=(2, 9)) * 0.7 ** np.arange(9)
    y = np.stack([x, -2 * x], -1)
    ref = np.asarray(jcheby.cheby_op(G.L, lmax, c, jnp.asarray(x)))
    ref_s = np.asarray(jcheby.cheby_synthesis(G.L, lmax, c, jnp.asarray(y)))
    return dict(lmax=lmax, x=x, c=c, y=y, ref=ref, ref_s=ref_s, mv=Ls @ x)


@pytest.mark.parametrize('layout', ['coo', 'ell', 'ell_split', 'win',
                                    'win_split'])
def test_one_rank_1d_engine(W, one_rank, layout):
    """A (1, 1) mesh with no process group takes the whole padded signal:
    the bank, the matvec, the synthesis and the fixed-graph VJP on every
    1-D layout within 1e-12 of the single-device reference."""
    p = one_rank
    sg = tpar.partition_graph(W, 1, dtype=np.float64, device='cpu')
    ell = {'coo': None, 'ell': lambda: tpar.shard_local_ell(sg),
           'ell_split': lambda: tpar.shard_local_ell(sg, split_boundary=True),
           'win': lambda: tpar.shard_local_windowed(sg),
           'win_split': lambda: tpar.shard_local_windowed(
               sg, split_boundary=True)}[layout]
    ell = ell() if ell else None
    mesh = tpar.make_mesh(1, 1, devices='cpu')
    perm = sg.perm.long()
    xp = sg.pad_signal(torch.tensor(p['x']))
    got = tpar.sharded_cheby_op(sg, p['lmax'], torch.tensor(p['c']), xp,
                                mesh, ell=ell)[:, perm].numpy()
    assert np.abs(got - p['ref']).max() <= 1e-12 * np.abs(p['ref']).max()
    mv = tpar.sharded_matvec(sg, xp, mesh, ell=ell)[perm].numpy()
    assert np.abs(mv - p['mv']).max() <= 1e-12 * np.abs(p['mv']).max()
    yp = sg.pad_signal(torch.tensor(p['y']))
    syn = tpar.sharded_cheby_synthesis(sg, p['lmax'], torch.tensor(p['c']),
                                       yp, mesh, ell=ell)[perm].numpy()
    assert np.abs(syn - p['ref_s']).max() <= \
        1e-12 * np.abs(p['ref_s']).max()
    x1 = xp[:, 0].clone()                         # a 1-D signal
    got1 = tpar.sharded_cheby_op(sg, p['lmax'], torch.tensor(p['c']), x1,
                                 mesh, ell=ell)[:, perm].numpy()
    assert np.abs(got1 - p['ref'][..., 0]).max() <= \
        1e-12 * np.abs(p['ref']).max()


def test_engine_refusals(W):
    sg = tpar.partition_graph(W, 2, dtype=np.float64, device='cpu')
    mesh = tpar.make_mesh(1, 1, devices='cpu')
    xp = torch.zeros(sg.n_local, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="'graph' axis"):
        tpar.sharded_cheby_op(sg, 2.0, torch.ones(1, 3), xp, mesh)
    one = tpar.partition_graph(W, 1, dtype=np.float64, device='cpu')
    with pytest.raises(ValueError, match='number of filters'):
        tpar.sharded_cheby_synthesis(one, 2.0, torch.ones(2, 3),
                                     torch.zeros(one.n_local, 3), mesh)
    with pytest.raises(ValueError, match='carry_dtype=bfloat16 refused'):
        tpar.sharded_cheby_op(one, 2.0, torch.ones(1, 31), xp[:, :1].float(),
                              mesh, carry_dtype=torch.bfloat16,
                              carry_tol=1e-9)
    with pytest.raises(TypeError, match='layout'):
        tpar.sharded_cheby_op(one, 2.0, torch.ones(1, 3),
                              torch.zeros(one.n_local, 2,
                                          dtype=torch.float64), mesh,
                              ell='bogus')


def _leaves(obj):
    return {f.name: (tuple(np.asarray(v) for v in getattr(obj, f.name))
                     if isinstance(getattr(obj, f.name), tuple)
                     and f.name not in ('halo_dists', 'halo_sizes',
                                        'lvl_src')
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_convert_carries_the_engines_objects(W):
    """``convert``'s functions make the port's ShardedGraph, ShardedELL,
    ShardedWindowed and TwoDGraph from the JAX objects' leaves, equal to
    the port's own builds, and refuse leaves out of range."""
    from pygsp_tpu_torch import convert
    ja = jpar.partition_graph(W, 4, dtype=np.float64)
    tb = tpar.partition_graph(W, 4, dtype=np.float64, device='cpu')
    got = convert.sharded_graph_from_numpy(_leaves(ja), device='cpu')
    assert_same(ja, got)
    n_ext = tb.n_local + tb.halo_total
    assert_same(tpar.shard_local_ell(tb), convert.sharded_ell_from_numpy(
        _leaves(jpar.shard_local_ell(ja)), n_ext, device='cpu'))
    for jw, tw in zip(jpar.shard_local_windowed(ja, split_boundary=True),
                      tpar.shard_local_windowed(tb, split_boundary=True)):
        assert_same(tw, convert.sharded_windowed_from_numpy(_leaves(jw),
                                                            device='cpu'))
    j2 = jpar.partition_graph_2d(W, 2, 2, dtype=np.float64)
    assert_same(j2, convert.twod_graph_from_numpy(_leaves(j2), device='cpu'))
    bad = _leaves(ja)
    bad['cols'] = np.asarray(bad['cols']).copy()
    bad['cols'][0, 0] = 10**6
    with pytest.raises(ValueError, match='cols out of range'):
        convert.sharded_graph_from_numpy(bad, device='cpu')
    bad = _leaves(j2)
    bad['perm'] = np.zeros_like(np.asarray(bad['perm']))
    with pytest.raises(ValueError, match='perm'):
        convert.twod_graph_from_numpy(bad, device='cpu')
    bad = _leaves(jpar.shard_local_ell(ja))
    with pytest.raises(ValueError, match='ELL cols'):
        convert.sharded_ell_from_numpy(bad, n_ext - 1, device='cpu')
