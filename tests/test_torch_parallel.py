"""The port's multi-device engines at world sizes 2 and 4 (gloo, on the
CPU) against single-device ``pygsp_tpu`` and the JAX package's own engines.

One spawn per world size (``tests/_torch_distributed_worker.py``, one
process per rank) runs every engine configuration there and writes each
rank's slices; the test assembles them and holds them, at float64, to the
JAX package's single-device ``cheby_op``/``cheby_synthesis``/``jax.vjp``
within 1e-12 of the largest value, and for one configuration of each
engine to the JAX engines on conftest's 8 CPU devices. The bf16 modes are
held to the float64 bank within twice their ``carry_error_estimate``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

import pygsp_tpu as gsp
from pygsp_tpu.ops import chebyshev as jcheby

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '_torch_distributed_worker.py')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_distributed_worker import (CARRY, CONFIGS, VJP,  # noqa: E402
                                       assemble)

TOL = 1e-12        # of the largest value, at float64


@pytest.fixture(scope='module')
def problem():
    G = gsp.graphs.StochasticBlockModel(N=192, k=3, seed=0)
    W = sps.csr_matrix(G.W)
    Ls = sps.diags(np.ravel(W.sum(axis=1))) - W
    lmax = 1.01 * float(sps.linalg.eigsh(Ls, k=1, which='LA')[0][0])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(G.N, 4))
    c = np.asarray(jcheby.cheby_coeff(
        gsp.filters.Heat(G, scale=[5.0, 20.0]).evaluate, lmax, m=12))
    gout = rng.normal(size=(2, G.N, 4))
    return G, W, lmax, x, c, gout


@pytest.fixture(scope='module')
def reference(problem):
    """The JAX package's single-device bank, matvec, synthesis and VJP."""
    G, _, lmax, x, c, gout = problem
    nf = c.shape[0]
    y = np.stack([x * (f + 1) for f in range(nf)], -1)
    bank, vjp = jax.vjp(lambda c_, x_: jcheby.cheby_op(G.L, lmax, c_, x_),
                        jnp.asarray(c), jnp.asarray(x))
    c_bar, x_bar = vjp(jnp.asarray(gout))
    Ls = sps.diags(np.ravel(problem[1].sum(axis=1))) - problem[1]
    return dict(fwd=np.asarray(bank), mv=Ls @ x,
                syn=np.asarray(jcheby.cheby_synthesis(G.L, lmax, c,
                                                      jnp.asarray(y))),
                cbar=np.asarray(c_bar), xbar=np.asarray(x_bar))


@pytest.fixture(scope='module')
def ranks(problem, tmp_path_factory):
    """Each world size's ranks' results, {world: [npz of rank r]}: both
    spawns run at once, one thread a process, each with a deadline so that
    a deadlock fails the test instead of running into the suite's clock."""
    _, W, lmax, x, c, gout = problem
    procs = {}
    for world in CONFIGS:
        work = tmp_path_factory.mktemp(f'world{world}')
        np.savez(work / 'problem.npz', w_data=W.data, w_indices=W.indices,
                 w_indptr=W.indptr, x=x, c=c, lmax=np.float64(lmax),
                 gout=gout)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        procs[world] = (work, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)])
    out = {}
    for world, (work, ps) in procs.items():
        for p in ps:
            try:
                _, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                pytest.fail(f'world {world}: a rank did not finish in 120 s')
            assert p.returncode == 0, err[-4000:]
        out[world] = [dict(np.load(work / f'rank{r}.npz'))
                      for r in range(world)]
    return out


def _cases(keys):
    return [pytest.param(world, name, id=f'w{world}-{name}')
            for world, configs in CONFIGS.items()
            for name, kind, _, layout in configs if keys(name, kind, layout)]


@pytest.mark.parametrize('world,name', _cases(lambda n, k, l: True))
def test_engine_bank_and_matvec(ranks, reference, world, name):
    """The bank and ``L @ x`` on every layout and mesh, within 1e-12 of the
    largest value of the single-device reference."""
    for key in ('fwd', 'mv'):
        got, want = assemble(ranks[world], name, key), reference[key]
        assert np.abs(got - want).max() <= TOL * np.abs(want).max(), key


@pytest.mark.parametrize('world,name', _cases(
    lambda n, k, l: k == '1d' or l.startswith(('ring', 'mono'))))
def test_engine_synthesis(ranks, reference, world, name):
    got, want = assemble(ranks[world], name, 'syn'), reference['syn']
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize('world,name', _cases(lambda n, k, l: n in VJP))
def test_engine_fixed_graph_vjp(ranks, reference, world, name):
    """c̄ (every rank the same, after the all_reduce) and x̄ of the
    fixed-graph VJP against ``jax.vjp`` of the single-device bank."""
    for p in ranks[world]:
        want = reference['cbar']
        assert np.abs(p[f'{name}__cbar'] - want).max() <= \
            TOL * np.abs(want).max()
    got, want = assemble(ranks[world], name, 'xbar'), reference['xbar']
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize('world,name', _cases(lambda n, k, l: n in CARRY))
def test_engine_bf16_carry(ranks, reference, problem, world, name):
    """The bf16 carry (with the bf16 'col' payload on the 2-D ring
    layouts) against the float64 bank, within twice the carry's a-priori
    bound."""
    from pygsp_tpu_torch.ops import carry_error_estimate
    import torch
    c = problem[4]
    got, want = assemble(ranks[world], name, 'bf16'), reference['fwd']
    bound = 2 * carry_error_estimate(c, torch.bfloat16)
    assert np.abs(got - want).max() / np.abs(want).max() <= bound


def test_engines_group_the_accumulation(problem, monkeypatch):
    """The engines take their accumulator group from the budget rule
    alone, so the spawned ranks above sum the bank's terms in groups
    (g > 1), as on the card: the JAX package's test-only override of its
    group does not reach the port."""
    import torch
    from pygsp_tpu_torch.parallel import sharded
    monkeypatch.setenv('PYGSP_SHARDED_ACC_GROUP', '1')
    n, s = problem[3].shape
    x = torch.zeros((n // 4, s), dtype=torch.float64)
    assert sharded._sharded_acc_group(x, 2, None, None, 4) == \
        sharded._MAX_GROUP > 1


def _jax_padded(out, perm, axis):
    return np.take(np.asarray(out), np.asarray(perm), axis=axis)


def test_1d_engine_matches_the_jax_engine(ranks, problem):
    """The 1-D engine at 4 ranks and on the (2, 2) graph × batch mesh
    against the JAX package's ``sharded_cheby_op``,
    ``sharded_cheby_synthesis`` and ``sharded_cheby_op_fixed_graph`` over
    the same partition. The JAX engines run on its COO layout: its
    windowed layouts take 15-30 s each to compile on the CPU, and every
    layout computes the same sums."""
    from pygsp_tpu import parallel as jpar
    G, W, lmax, x, c, gout = problem
    nf = c.shape[0]
    for name, (a, b) in (('1d_win_split', (4, 1)),
                         ('1d_batch_win_split', (2, 2))):
        sg = jpar.partition_graph(W, a, dtype=np.float64)
        mesh = jpar.make_mesh(a, b)
        xp = sg.pad_signal(x)
        want = _jax_padded(jpar.sharded_cheby_op(sg, lmax, c, xp, mesh),
                           sg.perm, 1)
        got = assemble(ranks[4], name, 'fwd')
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    yp = sg.pad_signal(np.stack([x * (f + 1) for f in range(nf)], -1))
    want = _jax_padded(jpar.sharded_cheby_synthesis(sg, lmax, c, yp, mesh),
                       sg.perm, 0)
    got = assemble(ranks[4], '1d_batch_win_split', 'syn')
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    gp = jnp.moveaxis(sg.pad_signal(np.moveaxis(gout, 0, 1)), 1, 0)
    _, vjp = jax.vjp(lambda c_, x_: jpar.sharded_cheby_op_fixed_graph(
        sg, lmax, c_, x_, mesh), jnp.asarray(c), xp)
    c_bar, x_bar = vjp(gp)
    got = assemble(ranks[4], '1d_batch_win_split', 'xbar')
    want = _jax_padded(x_bar, sg.perm, 0)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert np.abs(ranks[4][0]['1d_batch_win_split__cbar']
                  - np.asarray(c_bar)).max() <= TOL * np.abs(c_bar).max()


def test_2d_engine_matches_the_jax_engine(ranks, problem):
    """The 2-D engine on the (2, 2) mesh, the interleaved ring layout (the
    fused multi-matrix fold at pr = 2) and the COO one, against the JAX
    package's ``cheby_op_2d`` and ``matvec_2d`` on the same partition. The
    JAX engine runs its COO layout: its ring layouts take 44 s (bank) and
    157 s (VJP) to compile on the CPU, so the 2-D VJP is held to the
    single-device ``jax.vjp`` (:func:`test_engine_fixed_graph_vjp`)."""
    from pygsp_tpu import parallel as jpar
    G, W, lmax, x, c, gout = problem
    tg = jpar.partition_graph_2d(W, 2, 2, dtype=np.float64)
    mesh = jpar.make_mesh_2d(2, 2)
    xp = tg.pad_signal(x)
    bank = _jax_padded(jpar.cheby_op_2d(tg, lmax, c, xp, mesh), tg.perm, 1)
    mv = _jax_padded(jpar.matvec_2d(tg, xp, mesh), tg.perm, 0)
    for name in ('2d_ring_split', '2d_coo'):
        for key, want in (('fwd', bank), ('mv', mv)):
            got = assemble(ranks[4], name, key)
            assert np.abs(got - want).max() <= TOL * np.abs(want).max(), \
                (name, key)
