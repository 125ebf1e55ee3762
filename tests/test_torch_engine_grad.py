"""The port's multi-device engines under autograd at float64 on the CPU,
against ``jax.grad`` of ``pygsp_tpu``.

The bank (``sharded_cheby_op``, ``cheby_op_2d``), the synthesis
(``sharded_cheby_synthesis``, ``cheby_synthesis_2d``) and the matvec
(``sharded_matvec``, ``matvec_2d``) differentiate through the engines'
autograd Functions, whose backward runs exchanges of its own. One rank
runs in this process (a (1, 1) mesh with no process group); 2 and 4 gloo
ranks run in a spawn of ``tests/_torch_distributed_worker.py`` in its
``grad`` mode, one process a rank with a deadline. On every layout of its
``CONFIGS`` and at orders 12 and 30, each rank's c̄ (every rank the whole
c̄) and the assembled x̄ and ȳ are held within 1e-12 of the largest value
to ``jax.vjp`` of the JAX package's single-device ``cheby_op``,
``cheby_synthesis`` and ``L @ x``, and for one configuration of each
engine to ``jax.vjp`` of the JAX engine itself on conftest's CPU devices;
the padding rows' cotangents are exactly 0. What the engines do not
differentiate raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import pygsp_tpu as gsp
from pygsp_tpu.ops import chebyshev as jcheby

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_distributed_worker import (CONFIGS, GRAD_ONE,  # noqa: E402
                                       GRAD_ORDERS, assemble, grad_results,
                                       has_synthesis)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '_torch_distributed_worker.py')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12        # of the largest value, at float64
DEADLINE_S = 150
WORLDS = {1: GRAD_ONE, **CONFIGS}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny tensors: beside the
    suite's other workers and the spawned ranks, a pool of threads waits
    for busy cores at every op (one case took 142 s that takes 0.5 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def problem():
    """The SBM(192) heat bank of ``tests/test_torch_parallel.py`` at each
    order, x (N, 4), y = [x, 2x] and seeded cotangents."""
    G = gsp.graphs.StochasticBlockModel(N=192, k=3, seed=0)
    W = sps.csr_matrix(G.W)
    Ls = sps.diags(np.ravel(W.sum(axis=1))) - W
    lmax = 1.01 * float(sps.linalg.eigsh(Ls, k=1, which='LA')[0][0])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(G.N, 4))
    heat = gsp.filters.Heat(G, scale=[5.0, 20.0]).evaluate
    prob = {f'c{m}': np.asarray(jcheby.cheby_coeff(heat, lmax, m=m))
            for m in GRAD_ORDERS}
    nf = prob[f'c{GRAD_ORDERS[0]}'].shape[0]
    grng = np.random.default_rng(21)
    prob.update(x=x, lmax=np.float64(lmax),
                gbank=grng.normal(size=(nf, G.N, 4)),
                gsyn=grng.normal(size=(G.N, 4)),
                gmv=grng.normal(size=(G.N, 4)))
    return G, W, prob


@pytest.fixture(scope='module')
def spawned(problem, tmp_path_factory):
    """The 2- and 4-rank spawns, started: ``{world: (work dir,
    processes)}``."""
    _, W, prob = problem
    procs = {}
    for world in CONFIGS:
        work = tmp_path_factory.mktemp(f'grad{world}')
        np.savez(work / 'problem.npz', w_data=W.data, w_indices=W.indices,
                 w_indptr=W.indptr, **prob)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        procs[world] = (work, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(work),
             'grad'], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)])
    return procs


@pytest.fixture(scope='module')
def reference(problem):
    """``jax.vjp`` of the JAX package's single-device bank, synthesis and
    ``L @ x`` at each order, jitted once a function."""
    G, _, prob = problem
    x = jnp.asarray(prob['x'])
    nf = prob['gbank'].shape[0]
    y = jnp.stack([x * (f + 1) for f in range(nf)], -1)
    lmax = float(prob['lmax'])

    @jax.jit
    def bank(c, x, g):
        return jax.vjp(lambda c_, x_: jcheby.cheby_op(G.L, lmax, c_, x_),
                       c, x)[1](g)

    @jax.jit
    def synthesis(c, y, g):
        return jax.vjp(lambda c_, y_: jcheby.cheby_synthesis(G.L, lmax, c_,
                                                             y_), c, y)[1](g)

    out = {}
    for m in GRAD_ORDERS:
        c = jnp.asarray(prob[f'c{m}'])
        out[f'cbar{m}'], out[f'xbar{m}'] = bank(c, x, prob['gbank'])
        out[f'syn_cbar{m}'], out[f'ybar{m}'] = synthesis(c, y, prob['gsyn'])
    (out['mv_xbar'],) = jax.vjp(lambda x_: G.L @ x_, x)[1](
        jnp.asarray(prob['gmv']))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope='module')
def results(problem, spawned, reference):
    """Each world size's ranks' gradients, ``{world: [rank r's dict]}``:
    one rank here while the spawns run (and the JAX references compile
    first), then the spawns' files, each rank held to its deadline."""
    from pygsp_tpu_torch import parallel as par
    _, W, prob = problem
    out = {1: [grad_results(par, W, prob, GRAD_ONE, 'cpu')]}
    for world, (work, ps) in spawned.items():
        for p in ps:
            try:
                _, err = p.communicate(timeout=DEADLINE_S)
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                pytest.fail(f'world {world}: a rank did not finish in '
                            f'{DEADLINE_S} s')
            assert p.returncode == 0, err[-4000:]
        out[world] = [dict(np.load(work / f'rank{r}.npz'))
                      for r in range(world)]
    return out


def _cases(keep=lambda kind, layout: True, orders=GRAD_ORDERS):
    return [pytest.param(world, name, m, id=f'w{world}-{name}-o{m}')
            for world, configs in WORLDS.items()
            for name, kind, _, layout in configs if keep(kind, layout)
            for m in orders]


def _close(got, want, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f'{what}: {err:.3e} of the largest value'


def _check_local(parts, name, key, want):
    """The ranks' slices of ``key`` assembled against ``want``, and their
    padding rows exactly 0."""
    _close(assemble(parts, name, key), want, key)
    full = assemble(parts, name, key, padded=True)
    pad = np.setdiff1d(np.arange(full.shape[0]), parts[0][f'{name}__perm'])
    assert not np.any(full[pad]), f'{key}: a padding row is not 0'


def _check_cbar(parts, name, key, want):
    for r, p in enumerate(parts):
        _close(p[f'{name}__{key}'], want, f'rank {r} {key}')


@pytest.mark.parametrize('world,name,m', _cases())
def test_bank_grads(results, reference, world, name, m):
    """The bank's x̄ and every rank's c̄ against ``jax.vjp`` of the
    single-device bank."""
    parts = results[world]
    _check_local(parts, name, f'xbar{m}', reference[f'xbar{m}'])
    _check_cbar(parts, name, f'cbar{m}', reference[f'cbar{m}'])


@pytest.mark.parametrize('world,name,m', _cases(has_synthesis))
def test_synthesis_grads(results, reference, world, name, m):
    """The synthesis's ȳ (n, S, Nf) and every rank's c̄ against ``jax.vjp``
    of the single-device synthesis."""
    parts = results[world]
    _check_local(parts, name, f'ybar{m}', reference[f'ybar{m}'])
    _check_cbar(parts, name, f'syn_cbar{m}', reference[f'syn_cbar{m}'])


@pytest.mark.parametrize('world,name', [
    pytest.param(world, name, id=f'w{world}-{name}')
    for world, configs in WORLDS.items() for name, *_ in configs])
def test_matvec_grad(results, reference, world, name):
    """``L @ x``'s x̄ against ``jax.vjp`` of the single-device product."""
    _check_local(results[world], name, 'mv_xbar', reference['mv_xbar'])


@pytest.mark.parametrize('name', ['1d_coo', '1d_win_split'])
def test_fault_12_two_ranks_agree(results, reference, name):
    """Two ranks, order 12, COO and ``win_split``: x̄ came back 0.61 of the
    largest value off with no error while the halo rows' cotangents
    stayed on the rank that received them; each rank's c̄ was its own
    share only."""
    parts = results[2]
    _close(assemble(parts, name, 'xbar12'), reference['xbar12'], 'x̄')
    _check_cbar(parts, name, 'cbar12', reference['cbar12'])


@pytest.mark.parametrize('name', ['1d_coo', '1d_win_split'])
def test_fault_11_order_30_at_one_rank(problem, reference, name):
    """Order 30 with c requiring grad at one rank: the recurrence's ring of
    terms was rewritten under autograd once it wrapped ("modified by an
    inplace operation")."""
    from pygsp_tpu_torch import parallel as par
    _, W, prob = problem
    config = [cfg for cfg in GRAD_ONE if cfg[0] == name]
    got = grad_results(par, W, prob, config, 'cpu')
    _check_cbar([got], name, 'cbar30', reference['cbar30'])
    _check_cbar([got], name, 'syn_cbar30', reference['syn_cbar30'])


def _jax_padded(out, perm, axis):
    return np.take(np.asarray(out), np.asarray(perm), axis=axis)


def test_1d_engine_grads_match_the_jax_engine(results, problem):
    """The batch-sharded 1-D mesh (2 × 2, ``win_split``: c̄ summed over both
    axes, x̄ local) against ``jax.vjp`` of the JAX package's
    ``sharded_cheby_op`` over the same partition (its COO layout: its
    windowed layouts take 15-30 s each to compile on the CPU, and every
    layout computes the same sums)."""
    from pygsp_tpu import parallel as jpar
    _, W, prob = problem
    sg = jpar.partition_graph(W, 2, dtype=np.float64)
    mesh = jpar.make_mesh(2, 2)
    gp = jnp.moveaxis(sg.pad_signal(np.moveaxis(prob['gbank'], 0, 1)), 1, 0)
    _, vjp = jax.vjp(lambda c_, x_: jpar.sharded_cheby_op(
        sg, float(prob['lmax']), c_, x_, mesh), jnp.asarray(prob['c12']),
        sg.pad_signal(prob['x']))
    c_bar, x_bar = vjp(gp)
    parts = results[4]
    name = '1d_batch_win_split'
    _close(assemble(parts, name, 'xbar12'), _jax_padded(x_bar, sg.perm, 0),
           'x̄')
    _check_cbar(parts, name, 'cbar12', np.asarray(c_bar))


def test_2d_engine_grads_match_the_jax_engine(results, problem):
    """The 2-D engine on the 2 × 2 mesh (COO: c̄ summed over 'row' and
    'col') against ``jax.vjp`` of the JAX package's ``cheby_op_2d`` over
    the same partition."""
    from pygsp_tpu import parallel as jpar
    _, W, prob = problem
    tg = jpar.partition_graph_2d(W, 2, 2, dtype=np.float64)
    mesh = jpar.make_mesh_2d(2, 2)
    gp = jnp.moveaxis(tg.pad_signal(np.moveaxis(prob['gbank'], 0, 1)), 1, 0)
    _, vjp = jax.vjp(lambda c_, x_: jpar.cheby_op_2d(
        tg, float(prob['lmax']), c_, x_, mesh), jnp.asarray(prob['c12']),
        tg.pad_signal(prob['x']))
    c_bar, x_bar = vjp(gp)
    parts = results[4]
    _close(assemble(parts, '2d_coo', 'xbar12'),
           _jax_padded(x_bar, tg.perm, 0), 'x̄')
    _check_cbar(parts, '2d_coo', 'cbar12', np.asarray(c_bar))


# ---------------------------------------------------------------------------
# the refusals, at one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def one_rank(problem):
    """A float32 (1, 1) 1-D partition with its ``win_split`` layout, a
    (1, 1) 2-D partition with its ring layout, their meshes and a signal."""
    from pygsp_tpu_torch import parallel as par
    _, W, prob = problem
    sg = par.partition_graph(W, 1, device='cpu')
    tg = par.partition_graph_2d(W, 1, 1, device='cpu')
    return dict(sg=sg, ell=par.shard_local_windowed(sg, split_boundary=True),
                mesh=par.make_mesh(1, 1, devices='cpu'), tg=tg,
                ring=par.twod_local_windowed(tg, ring=True, chunk_rows=64),
                mesh2=par.make_mesh_2d(1, 1, devices='cpu'),
                x=sg.pad_signal(torch.tensor(prob['x'], dtype=torch.float32)),
                c=torch.tensor(prob['c12'], dtype=torch.float32),
                lmax=float(prob['lmax']))


def test_bf16_modes_refuse_autograd(one_rank):
    """``carry_dtype`` and ``scatter_dtype`` under autograd raise the bf16
    modes' ``ValueError`` (ROADMAP §1 item 6); without autograd they
    run."""
    from pygsp_tpu_torch import parallel as par
    o = one_rank
    c = o['c'].clone().requires_grad_()
    with pytest.raises(ValueError, match='§1 item 6'):
        par.sharded_cheby_op(o['sg'], o['lmax'], c, o['x'], o['mesh'],
                             ell=o['ell'], carry_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='§1 item 6'):
        par.cheby_op_2d(o['tg'], o['lmax'], c, o['x'], o['mesh2'],
                        ell=o['ring'], scatter_dtype=torch.bfloat16)
    y = torch.stack([o['x'], o['x']], -1).requires_grad_()
    with pytest.raises(ValueError, match='§1 item 6'):
        par.sharded_cheby_synthesis(o['sg'], o['lmax'], o['c'], y,
                                    o['mesh'], ell=o['ell'],
                                    carry_dtype=torch.bfloat16)
    with torch.no_grad():
        out = par.sharded_cheby_op(o['sg'], o['lmax'], c, o['x'], o['mesh'],
                                   ell=o['ell'], carry_dtype=torch.bfloat16)
    assert torch.isfinite(out).all()


def test_lmax_tensor_requiring_grad_raises(one_rank):
    """A λmax tensor that requires grad raises (§1 item 7) instead of being
    cut from the graph by ``float(lmax)``, even where c and x do not
    require grad; under ``torch.no_grad()`` it is a number."""
    from pygsp_tpu_torch import parallel as par
    o = one_rank
    lt = torch.tensor(o['lmax'], requires_grad=True)
    y = torch.stack([o['x'], o['x']], -1)
    calls = [lambda: par.sharded_cheby_op(o['sg'], lt, o['c'], o['x'],
                                          o['mesh'], ell=o['ell']),
             lambda: par.sharded_cheby_synthesis(o['sg'], lt, o['c'], y,
                                                 o['mesh'], ell=o['ell']),
             lambda: par.cheby_op_2d(o['tg'], lt, o['c'], o['x'], o['mesh2'],
                                     ell=o['ring']),
             lambda: par.cheby_synthesis_2d(o['tg'], lt, o['c'], y,
                                            o['mesh2'], ell=o['ring'])]
    for call in calls:
        with pytest.raises(ValueError, match='λmax.*§1 item 7'):
            call()
    with torch.no_grad():
        want = par.sharded_cheby_op(o['sg'], o['lmax'], o['c'], o['x'],
                                    o['mesh'], ell=o['ell'])
        assert torch.equal(calls[0](), want)


@pytest.mark.parametrize('field', ['vals', 'diag', 'layout'])
def test_partition_tensor_requiring_grad_raises(problem, field):
    """A partition value, its diagonal or a layout slab that requires grad
    raises (§1 item 7) in the bank and the matvec of both engines."""
    from pygsp_tpu_torch import parallel as par
    _, W, prob = problem
    sg = par.partition_graph(W, 1, device='cpu')
    ell = par.shard_local_windowed(sg, split_boundary=True)
    tg = par.partition_graph_2d(W, 1, 1, device='cpu')
    ring = par.twod_local_windowed(tg, ring=True, chunk_rows=64)
    if field == 'layout':
        ell[0].vals.requires_grad_()
        ring[0].vals.requires_grad_()
    else:
        getattr(sg, field).requires_grad_()
        getattr(tg, field).requires_grad_()
    x = sg.pad_signal(torch.tensor(prob['x'], dtype=torch.float32))
    c = torch.tensor(prob['c12'], dtype=torch.float32)
    lmax = float(prob['lmax'])
    mesh = par.make_mesh(1, 1, devices='cpu')
    mesh2 = par.make_mesh_2d(1, 1, devices='cpu')
    for call in (lambda: par.sharded_cheby_op(sg, lmax, c, x, mesh, ell=ell),
                 lambda: par.sharded_matvec(sg, x, mesh, ell=ell),
                 lambda: par.cheby_op_2d(tg, lmax, c, x, mesh2, ell=ring),
                 lambda: par.matvec_2d(tg, x, mesh2, ell=ring)):
        with pytest.raises(ValueError, match='partition.*§1 item 7'):
            call()


@pytest.mark.parametrize('exchange', ['ppermute_post', 'ppermute_chain_post',
                                      'all_gather', 'psum_scatter'])
def test_exchange_refuses_a_tensor_requiring_grad(exchange):
    """An exchange given a tensor that requires grad under grad mode raises
    (its cotangent would not return to the sender); under
    ``torch.no_grad()`` it runs."""
    from pygsp_tpu_torch.parallel import mesh as m
    mesh = m.Mesh({'row': 1, 'col': 1}, 'cpu')
    t = torch.ones(4, 2, requires_grad=True)
    call = {'ppermute_post': lambda: m.ppermute_wait(
                m.ppermute_post(mesh, 'row', [(1, t)])),
            'ppermute_chain_post': lambda: m.ppermute_wait(
                m.ppermute_chain_post(mesh, 'row', t, 1)),
            'all_gather': lambda: m.all_gather(mesh, 'row', t),
            'psum_scatter': lambda: m.psum_scatter(mesh, 'col', t)}[exchange]
    with pytest.raises(RuntimeError, match='requires grad'):
        call()
    with torch.no_grad():
        call()
