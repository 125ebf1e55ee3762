"""The engines' exchanges under their folds.

- **The schedule.** In one process, a recording stand-in takes the place
  of the mesh's post and wait (:func:`~pygsp_tpu_torch.parallel.mesh.
  ppermute_post`, :func:`~.mesh.ppermute_chain_post`,
  :func:`~.mesh.ppermute_wait`) and of the folds, on a mesh of several
  ranks seen from each of its coordinates. The received tensors it hands
  out hold a marker value, so a fold that reads one is seen. Each
  configuration's order of posts, folds and waits is the JAX package's:
  the 1-D split layouts fold the interior between the halo's post and its
  wait (``pygsp_tpu/parallel/sharded.py:_local_matvec``); the 2-D ring
  posts its chain of row shifts, folds ring step 0 under it, and after the
  wait folds steps 1..pr−1 in one launch; each column hop is posted before
  its position's fold and waited for after it (``pygsp_tpu/parallel/
  twod.py:_ring_body_setup``). No fold reads a received tensor before its
  wait.
- **Post and wait at two gloo ranks** (``tests/_torch_overlap_worker.py``,
  one spawn): what is received is what the peer sent, a shift of 0 is the
  tensor itself, a handle is waited for once, and the chain's k-th tensor
  is the one of the rank k + 1 behind.
- **Bits.** The 1-D split layouts' products with the interior folded
  under the halo are bit-equal to the same sums with the wait first.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pygsp_tpu_torch import parallel as par
from pygsp_tpu_torch.parallel import mesh as pm
from pygsp_tpu_torch.parallel import sharded, twod

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, '_torch_overlap_worker.py')
sys.path.insert(0, HERE)
from _torch_distributed_worker import layout_1d, layout_2d  # noqa: E402
from _torch_overlap_worker import sent  # noqa: E402

MARK = 12345.0          # what every received tensor of the stand-in holds
DEADLINE_S = 30


class FakeMesh:
    """A mesh of ``shape`` seen from ``coords``, with no process group."""

    def __init__(self, shape, coords):
        self.shape, self.axis_names = dict(shape), tuple(shape)
        self.coords = coords
        self.device = torch.device('cpu')

    def index(self, name):
        return self.coords[self.axis_names.index(name)]


class Recorder:
    """The stand-in: records ``('post', axis)``, ``('wait', axis)`` and
    ``('fold', what, reads a received tensor)`` in issue order."""

    def __init__(self, monkeypatch, interior=None):
        self.events, self.interior = [], interior
        self.folds = sharded._product, twod.spmm_multi_internal
        for mod in (sharded, twod):
            monkeypatch.setattr(mod, 'ppermute_post', self.post)
            monkeypatch.setattr(mod, 'ppermute_wait', self.wait)
            monkeypatch.setattr(mod, '_product', self.product)
        monkeypatch.setattr(twod, 'ppermute_chain_post', self.chain_post)
        monkeypatch.setattr(twod, 'spmm_multi_internal', self.multi)

    def post(self, mesh, name, sends):
        self.events.append(('post', name))
        return name, [t for _, t in sends]

    def chain_post(self, mesh, name, t, links):
        self.events.append(('post', name))
        return name, [t] * links

    def wait(self, handle):
        name, sends = handle
        self.events.append(('wait', name))
        return [torch.full_like(t, MARK) for t in sends]

    def _fold(self, what, xs):
        self.events.append(('fold', what,
                            any(bool((x == MARK).any()) for x in xs)))

    def product(self, mat, x, out_dtype):
        if self.interior is not None:
            what = 'interior' if mat is self.interior else 'boundary'
        else:
            what = 'mono'
        self._fold(what, [x])
        return self.folds[0](mat, x, out_dtype)

    def multi(self, mats, xs, residue, out_dtype=None):
        self._fold(len(mats), xs)
        return self.folds[1](mats, xs, residue, out_dtype=out_dtype)


@pytest.fixture(scope='module')
def W():
    """A random symmetric graph of 192 vertices (numpy, seeded)."""
    A = sps.random(192, 192, density=0.04, random_state=11, format='csr')
    A = ((A + A.T) > 0).astype(np.float64)
    A.setdiag(0)
    A.eliminate_zeros()
    return A.tocsr()


# a matvec's events by 1-D layout and by 2-D (layout, (pr, pc)): a post or
# a wait along an axis; a fold of a kind (1-D: interior or boundary; 2-D:
# the fused SpMM's count of matrices, or a mono fold) and whether it reads
# a received tensor
ONE_D = {
    'win_split': [('post', 'graph'), ('fold', 'interior', False),
                  ('wait', 'graph'), ('fold', 'boundary', True)],
    'ell_split': [('post', 'graph'), ('fold', 'interior', False),
                  ('wait', 'graph'), ('fold', 'boundary', True)],
}
TWO_D = {
    ('ring_split', (2, 2)): [
        ('post', 'row'), ('fold', 1, False), ('wait', 'row'),
        ('fold', 1, True),
        ('post', 'col'), ('fold', 2, True), ('wait', 'col')],
    ('ring_split', (4, 1)): [
        ('post', 'row'), ('fold', 1, False), ('wait', 'row'),
        ('fold', 3, True)],
    ('ring', (4, 1)): [
        ('post', 'row'), ('fold', 1, False), ('wait', 'row'),
        ('fold', 3, True)],
    ('mono_split', (2, 2)): [
        ('post', 'row'), ('wait', 'row'), ('fold', 'mono', True),
        ('post', 'col'), ('fold', 'mono', True), ('wait', 'col')],
}


@pytest.mark.parametrize('shard', [0, 1])
@pytest.mark.parametrize('layout', sorted(ONE_D))
def test_1d_split_folds_the_interior_under_the_halo(W, monkeypatch, layout,
                                                    shard):
    sg = par.partition_graph(W, 2, dtype=np.float64, device='cpu')
    ell = layout_1d(par, sg, layout)
    sh = sharded._Shard(sg, FakeMesh({'graph': 2, 'batch': 1}, (shard, 0)),
                        ell)
    assert sg.halo_total > 0 and sh.mats[1] is not None
    rec = Recorder(monkeypatch, interior=sh.mats[0])
    x = torch.from_numpy(np.random.default_rng(shard).standard_normal(
        (sg.n_local, 3)))
    y = sh.product(x, x.dtype)
    assert rec.events == ONE_D[layout]
    assert y.shape == x.shape


@pytest.mark.parametrize('layout,shape,coords', [
    pytest.param(layout, shape, (i, j), id=f'{layout}-{shape}-{i}{j}')
    for layout, shape in sorted(TWO_D)
    for i in range(shape[0]) for j in range(shape[1])])
def test_2d_ring_folds_under_its_shifts_and_hops(W, monkeypatch, layout,
                                                 shape, coords):
    tg = par.partition_graph_2d(W, *shape, dtype=np.float64, device='cpu')
    ell = layout_2d(par, tg, layout)
    dv = twod._Device2D(tg, FakeMesh({'row': shape[0], 'col': shape[1]},
                                     coords), ell)
    rec = Recorder(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (tg.n_local, 3)))
    y = dv.product(x, x.dtype)
    assert rec.events == TWO_D[layout, shape]
    assert y.shape == x.shape


def test_ring_split_at_one_rank_is_one_fold(W, monkeypatch):
    """pr = 1: no shift to hide, so one fused fold a position and no
    split."""
    tg = par.partition_graph_2d(W, 1, 1, dtype=np.float64, device='cpu')
    dv = twod._Device2D(tg, FakeMesh({'row': 1, 'col': 1}, (0, 0)),
                        layout_2d(par, tg, 'ring_split'))
    rec = Recorder(monkeypatch)
    dv.product(torch.ones(tg.n_local, 2, dtype=torch.float64),
               torch.float64)
    assert rec.events == [('post', 'row'), ('wait', 'row'),
                          ('fold', 1, False)]


def test_one_rank_mesh_posts_nothing():
    """A one-rank mesh with no process group: a shift and a chain come
    back as the tensor itself, and a handle is waited for once."""
    mesh = par.make_mesh(1, 1, devices='cpu')
    t = torch.ones(3)
    handle = pm.ppermute_post(mesh, 'graph', [(1, t), (0, t)])
    assert all(r is t for r in pm.ppermute_wait(handle))
    with pytest.raises(RuntimeError, match='already'):
        pm.ppermute_wait(handle)
    chain = pm.ppermute_wait(pm.ppermute_chain_post(mesh, 'graph', t, 2))
    assert len(chain) == 2 and all(r is t for r in chain)
    assert pm.ppermute(mesh, 'graph', [(3, t)])[0] is t


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """Each rank's results of ``tests/_torch_overlap_worker.py``, one
    spawn of two gloo ranks with a deadline."""
    work = tmp_path_factory.mktemp('overlap')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), '2',
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f'a rank did not finish in {DEADLINE_S} s')
        assert p.returncode == 0, err[-4000:]
    return [dict(np.load(work / f'rank{r}.npz')) for r in range(2)]


@pytest.mark.parametrize('rank', [0, 1])
def test_post_and_wait_at_two_ranks(two_ranks, rank):
    got, peer = two_ranks[rank], sent(1 - rank).numpy()
    assert np.array_equal(got['shift1'], peer)
    assert np.array_equal(got['ppermute'], peer)
    assert bool(got['shift0_is_the_tensor'])
    assert bool(got['second_wait_raised'])
    # on a ring of two, the chain's second link brings back our own
    assert np.array_equal(got['chain'],
                          np.stack([peer, sent(rank).numpy()]))


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('layout', ['win_split', 'ell_split'])
@pytest.mark.parametrize('rank', [0, 1])
def test_1d_split_is_bit_equal_to_waiting_first(two_ranks, rank, layout,
                                                dtype):
    got = two_ranks[rank]
    key = f'{layout}_{dtype}'
    assert int(got[f'{key}_halo']) > 0
    assert np.array_equal(got[f'{key}_overlapped'], got[f'{key}_waited'])
