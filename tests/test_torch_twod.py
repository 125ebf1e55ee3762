"""The fused multi-matrix fold and the 2-D engine at one rank.

The fold (``core.windowed.windowed_spmm_chunks_multi``: one launch of
``windowed_fold_multi`` over every matrix's slabs, then one
``window_strip`` over every matrix's residue list) is held, through its
plain version on the CPU, against the JAX package's
``windowed_spmm_chunks_multi`` on device (0, 0)'s ring matrices of
``partition_graph_2d(W, 4, 4)`` (the card's path L3 at a small size), in
float64 within 1e-12 and in the bf16 carry within its roundings. A
(1, 1) ``('row', 'col')`` mesh runs every 2-D layout with no process
group against the JAX package's single-device bank.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import pygsp_tpu as gsp
from pygsp_tpu import parallel as jpar
from pygsp_tpu.core import windowed as jwin
from pygsp_tpu.ops import chebyshev as jcheby

from pygsp_tpu_torch import parallel as tpar
from pygsp_tpu_torch.core import windowed as twin
from pygsp_tpu_torch.core import windowed_kernel as wk
from pygsp_tpu_torch.parallel.partition import shard_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def W():
    return sps.csr_matrix(gsp.graphs.Sensor(200, seed=7).W)


@pytest.fixture(scope='module')
def ring_mats(W):
    """Device (0, 0)'s pr = 4 ring matrices of the 4 × 4 partition, the
    JAX package's and the port's, with one x per matrix."""
    kw = dict(ring=True, chunk_rows=16, window_rows=8)
    ja = jpar.twod_local_windowed(jpar.partition_graph_2d(
        W, 4, 4, dtype=np.float64), **kw)
    tb = tpar.twod_local_windowed(tpar.partition_graph_2d(
        W, 4, 4, dtype=np.float64, device='cpu'), **kw)
    jm = [jpar.ShardedWindowed(**{
        f: (getattr(e, f)[0:1] if f in ('cols', 'vals', 'rowid',
                                        'level_rows')
            else tuple(v[0:1] for v in getattr(e, f))
            if f in ('lvl_cols', 'lvl_vals') else getattr(e, f))
        for f in e.__dataclass_fields__}).local_matrix() for e in ja]
    tm = [shard_slice(e, 0).local_matrix() for e in tb]
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(m.n_cols, 6)) for m in tm]
    return jm, tm, xs


def test_ring_matrices_differ_in_shape(ring_mats):
    """The case the fused fold must take: slab widths or source-chunk
    counts that differ between matrices, and residue tiers."""
    _, tm, _ = ring_mats
    assert len({tuple(m.cols.shape[2:]) for m in tm}) > 1
    assert any(m.residue is not None for m in tm)


def test_fused_fold_matches_jax(ring_mats):
    jm, tm, xs = ring_mats
    R = tm[0].chunk_rows
    want = np.concatenate(jwin.windowed_spmm_chunks_multi(
        jm, [tuple(jnp.asarray(x[i:i + R]) for i in range(0, len(x), R))
             for x in xs]))
    got = twin.windowed_spmm_chunks_multi(
        tm, [tuple(torch.tensor(x[i:i + R]) for i in range(0, len(x), R))
             for x in xs])
    got = torch.cat(got).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    one = twin.spmm_multi_internal(
        tm[:1], [torch.tensor(xs[0])],
        wk.merge_residues([tm[0].residue], tm[0].n_rows)).numpy()
    alone = twin.spmm_internal(tm[0], torch.tensor(xs[0])).numpy()
    assert np.array_equal(one, alone)


def test_fused_fold_bf16_carry(ring_mats):
    """A bf16 x with float32 values and a bf16 output (the 2-D engine's
    fast mode) against the float64 sum, within the roundings of its inputs
    and one rounding of the output."""
    _, tm, xs = ring_mats
    m32 = [m.astype(torch.float32) for m in tm]
    xb = [torch.tensor(x, dtype=torch.bfloat16) for x in xs]
    merged = wk.merge_residues([m.residue for m in m32], m32[0].n_rows)
    got = twin.spmm_multi_internal(m32, xb, merged, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = sum(twin.spmm_internal(m, x.double()) for m, x in zip(tm, xb))
    scale = sum((twin.spmm_internal(m.abs_vals(), x.double().abs()))
                for m, x in zip(tm, xb)).max()
    err = (got.double() - want).abs().max()
    assert err <= 2 * 2.0**-8 * float(scale)


def test_fused_fold_plain_is_the_sum_of_folds(ring_mats):
    """The plain multi-matrix fold is the sum of the single folds' sums,
    rounded once; its strip over the merged residue list is each matrix's
    strip, added."""
    _, tm, xs = ring_mats
    x = [torch.tensor(v) for v in xs]
    R, KP = tm[0].chunk_rows, tm[0].borrow_span * tm[0].window_rows
    slabs = [(m.cols, m.vals, m.rowid) for m in tm]
    t = wk.windowed_fold_multi(slabs, x, R, KP)
    ts = sum(wk.windowed_fold(*s, v, R, KP) for s, v in zip(slabs, x))
    assert torch.allclose(t, ts, rtol=0, atol=1e-13)
    merged = wk.merge_residues([m.residue for m in tm], tm[0].n_rows)
    assert merged.emat.numel() == sum(
        m.residue.entptr.numel() - 1 for m in tm if m.residue is not None)
    assert torch.equal(merged.rowptr[-1:].long(),
                       merged.entptr.new_tensor([merged.emat.numel()]))
    y = wk.window_strip(t, tm[0].n_rows, tm[0].window_rows, merged, x)
    want = sum(twin.spmm_internal(m, v) for m, v in zip(tm, x))
    assert torch.allclose(y, want, rtol=0, atol=1e-12)


def test_fused_fold_refusals(ring_mats):
    _, tm, xs = ring_mats
    x = [torch.tensor(v) for v in xs]
    other = twin.windowed_from_scipy(sps.random(tm[0].n_rows, 40,
                                                density=0.1, random_state=0),
                                     dtype=torch.float64, chunk_rows=32,
                                     window_rows=8, permute=None,
                                     device='cpu')
    with pytest.raises(ValueError, match='fused SpMM requires matching'):
        twin.spmm_multi_internal([tm[0], other], [x[0], torch.zeros(40, 6)],
                                 None)
    slabs = [(m.cols, m.vals, m.rowid) for m in tm]
    R, KP = tm[0].chunk_rows, tm[0].borrow_span * tm[0].window_rows
    with pytest.raises(ValueError, match='1 to 16'):
        wk.windowed_fold_multi(slabs * 5, x * 5, R, KP)
    with pytest.raises(ValueError, match='share'):
        wk.windowed_fold_multi(
            [slabs[0], (slabs[1][0], slabs[1][1].float(), slabs[1][2])],
            [x[0], x[1].float()], R, KP)


def test_multi_layout_and_source_constants():
    """The multi-matrix fold's shared memory is the single fold's and a
    4-byte matrix id per queue entry; its table size is the source's."""
    one = wk.fold_layout(256, 128, 4)
    multi = wk.fold_layout(256, 128, 4, multi=True)
    assert multi.smem_bytes == one.smem_bytes + 4 * one.queue
    with open(os.path.join(REPO, 'pygsp_tpu_torch', 'csrc',
                           'windowed_fold.cu')) as f:
        src = f.read()
    assert int(re.search(r'kMaxMats = (\d+);', src).group(1)) == \
        wk.MAX_MATS


@pytest.fixture(scope='module')
def single(W):
    G = gsp.graphs.Graph(W)
    Ls = sps.diags(np.ravel(W.sum(axis=1))) - W
    lmax = 1.01 * float(sps.linalg.eigsh(Ls, k=1, which='LA')[0][0])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(W.shape[0], 3))
    c = np.asarray(jcheby.cheby_coeff(
        gsp.filters.Heat(G, scale=[4.0, 10.0]).evaluate, lmax, m=10))
    y = np.stack([x, 0.5 * x], -1)
    return dict(lmax=lmax, x=x, c=c, y=y, Ls=Ls,
                ref=np.asarray(jcheby.cheby_op(G.L, lmax, c,
                                               jnp.asarray(x))),
                ref_s=np.asarray(jcheby.cheby_synthesis(G.L, lmax, c,
                                                        jnp.asarray(y))))


LAYOUTS = {'coo': None, 'win': dict(),
           'ring': dict(ring=True, chunk_rows=64),
           'ring_split': dict(ring=True, split_cols=True, chunk_rows=64),
           'mono': dict(ring=True, mono=True, chunk_rows=8, window_rows=8),
           'mono_split': dict(ring=True, mono=True, split_cols=True,
                              chunk_rows=8, window_rows=8)}


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_one_rank_2d_engine(W, single, layout):
    """A (1, 1) mesh with no process group: bank, matvec, synthesis (ring
    layouts) and the fixed-graph VJP (ring layouts, against the adjoint
    identities) within 1e-12 of the single-device reference."""
    p = single
    tg = tpar.partition_graph_2d(W, 1, 1, dtype=np.float64, device='cpu')
    kw = LAYOUTS[layout]
    ell = None if kw is None else tpar.twod_local_windowed(tg, **kw)
    mesh = tpar.make_mesh_2d(1, 1, devices='cpu')
    perm = tg.perm.long()
    c = torch.tensor(p['c'])
    xp = tg.pad_signal(torch.tensor(p['x']))
    got = tpar.cheby_op_2d(tg, p['lmax'], c, xp, mesh, ell=ell)[:, perm]
    assert np.abs(got.numpy() - p['ref']).max() <= \
        1e-12 * np.abs(p['ref']).max()
    mv = tpar.matvec_2d(tg, xp, mesh, ell=ell)[perm].numpy()
    want = p['Ls'] @ p['x']
    assert np.abs(mv - want).max() <= 1e-12 * np.abs(want).max()
    if not isinstance(ell, tuple):
        with pytest.raises(ValueError, match='ring layout'):
            tpar.cheby_synthesis_2d(tg, p['lmax'], c,
                                    tg.pad_signal(torch.tensor(p['y'])),
                                    mesh, ell=ell)
        with pytest.raises(ValueError, match='ring layout'):
            tpar.cheby_op_2d(tg, p['lmax'], c, xp, mesh, ell=ell,
                             scatter_dtype=torch.bfloat16)
        return
    syn = tpar.cheby_synthesis_2d(tg, p['lmax'], c,
                                  tg.pad_signal(torch.tensor(p['y'])),
                                  mesh, ell=ell)[perm].numpy()
    assert np.abs(syn - p['ref_s']).max() <= 1e-12 * np.abs(p['ref_s']).max()
    cg, xg = c.clone().requires_grad_(), xp.clone().requires_grad_()
    g = torch.randn(got.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    gp = torch.zeros((c.shape[0],) + tuple(xp.shape), dtype=torch.float64)
    gp[:, perm] = g
    (tpar.cheby_op_2d_fixed_graph(tg, p['lmax'], cg, xg, mesh, ell=ell)
     * gp).sum().backward()
    # ⟨ḡ, bank(c, x)⟩ is linear in each: c̄·c and x̄·x give it back
    total = float((gp[:, perm] * got).sum())
    assert abs(float((cg.grad * c).sum()) - total) <= 1e-12 * abs(total)
    assert abs(float((xg.grad * xp).sum()) - total) <= 1e-12 * abs(total)


def test_one_rank_2d_bf16(W, single):
    """The bf16 carry on the interleaved ring layout, with a bf16 'col'
    payload, against the float64 bank within twice the carry's bound."""
    from pygsp_tpu_torch.ops import carry_error_estimate
    p = single
    tg = tpar.partition_graph_2d(W, 1, 1, device='cpu')
    ell = tpar.twod_local_windowed(tg, ring=True, split_cols=True,
                                   chunk_rows=64)
    mesh = tpar.make_mesh_2d(1, 1, devices='cpu')
    xp = tg.pad_signal(torch.tensor(p['x'], dtype=torch.float32))
    got = tpar.cheby_op_2d(tg, p['lmax'], torch.tensor(p['c']).float(), xp,
                           mesh, ell=ell, carry_dtype=torch.bfloat16,
                           scatter_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    rel = (np.abs(got[:, tg.perm.long()].numpy() - p['ref']).max()
           / np.abs(p['ref']).max())
    assert rel <= 2 * carry_error_estimate(p['c'], torch.bfloat16)
