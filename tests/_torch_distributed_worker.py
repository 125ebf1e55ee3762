"""One rank of the port's multi-process engine tests (gloo on the CPU).

Run by ``tests/test_torch_parallel.py`` as ``python
_torch_distributed_worker.py <rank> <world> <work dir>``: it joins a gloo
group through a file under the work dir, reads the problem the test wrote
(``problem.npz``: the adjacency, x, c, λmax), runs every engine
configuration of its world size on its slice of the signal, and writes its
slices, with what places them, and the kernel launches of its matvec to
``rank<r>.npz``. A further argument ``cuda`` runs it on the rank's card
with NCCL instead (``tools/engines_multicard.py``); ``grad`` runs the
engines under autograd instead (:func:`grad_results`, the problem then
holding the coefficients of each of :data:`GRAD_ORDERS` and the
cotangents; ``tests/test_torch_engine_grad.py``). It imports torch and
the port only.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scipy.sparse as sps  # noqa: E402
import torch  # noqa: E402

# (name, kind, mesh shape, layout) by world size; the layouts are those of
# parallel.shard_local_* and parallel.twod_local_windowed
CONFIGS = {
    2: [('1d_coo', '1d', (2, 1), 'coo'),
        ('1d_ell', '1d', (2, 1), 'ell'),
        ('1d_ell_split', '1d', (2, 1), 'ell_split'),
        ('1d_win', '1d', (2, 1), 'win'),
        ('1d_win_split', '1d', (2, 1), 'win_split'),
        ('2d_ring_split', '2d', (2, 1), 'ring_split')],
    4: [('1d_coo', '1d', (4, 1), 'coo'),
        ('1d_win_split', '1d', (4, 1), 'win_split'),
        ('1d_batch_win_split', '1d', (2, 2), 'win_split'),
        ('2d_coo', '2d', (2, 2), 'coo'),
        ('2d_win', '2d', (2, 2), 'win'),
        ('2d_ring', '2d', (2, 2), 'ring'),
        ('2d_ring_split', '2d', (2, 2), 'ring_split'),
        ('2d_mono', '2d', (2, 2), 'mono'),
        ('2d_mono_split', '2d', (2, 2), 'mono_split'),
        ('2d_ring_split_41', '2d', (4, 1), 'ring_split')],
}

# the configurations whose bf16 carry (and, on 2-D ring layouts, bf16
# scatter) and fixed-graph VJP also run
CARRY = {'1d_win_split', '1d_batch_win_split', '2d_ring_split',
         '2d_mono', '2d_ring_split_41'}
VJP = {'1d_coo', '1d_win_split', '1d_batch_win_split', '2d_ring_split',
       '2d_ring_split_41', '2d_mono_split'}


# the grad mode: the orders at which each configuration differentiates,
# and the configurations of one rank (a (1, 1) mesh with no process group,
# run in the test's own process)
GRAD_ORDERS = (12, 30)
GRAD_ONE = [('1d_coo', '1d', (1, 1), 'coo'),
            ('1d_ell', '1d', (1, 1), 'ell'),
            ('1d_ell_split', '1d', (1, 1), 'ell_split'),
            ('1d_win', '1d', (1, 1), 'win'),
            ('1d_win_split', '1d', (1, 1), 'win_split'),
            ('2d_coo', '2d', (1, 1), 'coo'),
            ('2d_win', '2d', (1, 1), 'win'),
            ('2d_ring_split', '2d', (1, 1), 'ring_split')]


def has_synthesis(kind, layout):
    """Whether a configuration's engine has a public synthesis: the 1-D
    engine, and the 2-D one on its ring layouts."""
    return kind == '1d' or layout.startswith(('ring', 'mono'))


# the kernels whose launches each configuration's matvec records (one
# product: on the card at pr > 1, the fused SpMM twice at fold position 0,
# ring step 0 alone under the row shifts and steps 1..pr-1 after them, and
# once at each of the interleaved ring's pc - 1 other positions)
LAUNCHED = ('fold_strip_multi', 'windowed_fold_multi', 'windowed_fold',
            'window_strip')


def layout_1d(par, sg, name):
    if name == 'coo':
        return None
    if name == 'ell':
        return par.shard_local_ell(sg)
    if name == 'ell_split':
        return par.shard_local_ell(sg, split_boundary=True)
    if name == 'win':
        return par.shard_local_windowed(sg)
    return par.shard_local_windowed(sg, split_boundary=True)


def layout_2d(par, tg, name):
    if name == 'coo':
        return None
    if name == 'win':
        return par.twod_local_windowed(tg)
    if name.startswith('mono'):
        return par.twod_local_windowed(tg, ring=True, mono=True,
                                       split_cols=name.endswith('split'),
                                       chunk_rows=8, window_rows=8)
    return par.twod_local_windowed(tg, ring=True, chunk_rows=64,
                                   split_cols=name.endswith('split'))


def assemble(parts, name, key, padded=False):
    """The ranks' slices of ``key`` (from their ``rank<r>.npz``) placed in
    the padded signal and taken back to the original vertex order (vertex
    axis 1 for a bank); with ``padded`` the padded signal itself. Axes
    after the columns (a synthesis's filter axis) come along."""
    bank = key in ('fwd', 'bf16')
    perm = parts[0][f'{name}__perm']
    first = parts[0][f'{name}__{key}']
    n_local, cols = (int(v) for v in parts[0][f'{name}__place'][2:])
    n_parts = 1 + max(int(p[f'{name}__place'][0]) for p in parts)
    n_blocks = 1 + max(int(p[f'{name}__place'][1]) for p in parts)
    shape = (n_parts * n_local, n_blocks * cols)
    out = np.zeros((first.shape[0],) + shape if bank
                   else shape + first.shape[2:])
    for p in parts:
        part, block = (int(v) for v in p[f'{name}__place'][:2])
        rows = slice(part * n_local, (part + 1) * n_local)
        cs = slice(block * cols, (block + 1) * cols)
        if bank:
            out[:, rows, cs] = p[f'{name}__{key}']
        else:
            out[rows, cs] = p[f'{name}__{key}']
    if padded:
        return out
    return out[:, perm] if bank else out[perm]


def launch_counts():
    """The launches so far of the windowed kernels that a 2-D ring layout
    takes (:data:`LAUNCHED`); all 0 on the CPU, where the wrappers run
    their plain versions."""
    from pygsp_tpu_torch.core import windowed_kernel as wk
    return np.array([getattr(wk, k).launches for k in LAUNCHED])


def configure(par, W, x, kind, shape, layout, dev):
    """One configuration on this rank: ``(mesh, partition, layout,
    engines, place, local)``; ``place`` is ``[part, block, n_local,
    cols]`` (what :func:`assemble` reads) and ``local(a)`` this rank's
    slice of a vertex-first array (N, S, ...) of the original order."""
    a, b = shape
    if kind == '1d':
        mesh = par.make_mesh(a, b, devices=dev)
        sg = par.partition_graph(W, a, dtype=np.float64, device=dev)
        ell = layout_1d(par, sg, layout)
        part, block = mesh.index('graph'), mesh.index('batch')
        if b > 1:      # this rank's own shard only, as a launch keeps it
            sg = par.put_sharded_graph(sg, mesh)
        engines = dict(op=par.sharded_cheby_op,
                       syn=par.sharded_cheby_synthesis,
                       fg=par.sharded_cheby_op_fixed_graph,
                       mv=par.sharded_matvec)
    else:
        mesh = par.make_mesh_2d(a, b, devices=dev)
        sg = par.partition_graph_2d(W, a, b, dtype=np.float64, device=dev)
        ell = layout_2d(par, sg, layout)
        part, block = mesh.rank, 0
        engines = dict(op=par.cheby_op_2d, syn=par.cheby_synthesis_2d,
                       fg=par.cheby_op_2d_fixed_graph, mv=par.matvec_2d)
    n_local = sg.n_local
    cols = x.shape[1] // (b if kind == '1d' else 1)
    rows = slice(part * n_local, (part + 1) * n_local)
    cs = slice(block * cols, (block + 1) * cols)

    def local(arr):
        padded = sg.pad_signal(torch.as_tensor(arr, device=dev))
        return padded[rows, cs].contiguous()

    return (mesh, sg, ell, engines, np.array([part, block, n_local, cols]),
            local)


def engine_results(par, W, prob, configs, dev):
    """Every configuration's bank, matvec (and its launches), synthesis,
    bf16 modes and fixed-graph VJP on this rank."""
    x, c, lmax = prob['x'], torch.tensor(prob['c'], device=dev), \
        float(prob['lmax'])
    nf = c.shape[0]
    out = {}
    for name, kind, shape, layout in configs:
        a, b = shape
        mesh, sg, ell, engines, place, local = configure(
            par, W, x, kind, shape, layout, dev)
        xl = local(x)
        key = f'{name}__'
        out[key + 'perm'] = sg.perm.cpu().numpy()
        out[key + 'place'] = place
        out[key + 'fwd'] = engines['op'](sg, lmax, c, xl, mesh,
                                         ell=ell).cpu().numpy()
        before = launch_counts()
        out[key + 'mv'] = engines['mv'](sg, xl, mesh,
                                        ell=ell).cpu().numpy()
        out[key + 'launches'] = launch_counts() - before
        if has_synthesis(kind, layout):
            y = torch.stack([xl * (f + 1) for f in range(nf)], -1)
            out[key + 'syn'] = engines['syn'](sg, lmax, c, y, mesh,
                                              ell=ell).cpu().numpy()
        if name in CARRY:
            if kind == '1d':
                sg32 = par.partition_graph(W, a, device=dev)
                ell32 = layout_1d(par, sg32, layout)
                if b > 1:
                    sg32 = par.put_sharded_graph(sg32, mesh)
                kw = {}
            else:
                sg32 = par.partition_graph_2d(W, a, b, device=dev)
                ell32 = layout_2d(par, sg32, layout)
                kw = ({'scatter_dtype': torch.bfloat16}
                      if layout.startswith('ring') else {})
            out[key + 'bf16'] = engines['op'](
                sg32, lmax, c.float(), xl.float(), mesh, ell=ell32,
                carry_dtype=torch.bfloat16, **kw).cpu().numpy()
        if name in VJP:
            cg = c.clone().requires_grad_()
            xg = xl.clone().requires_grad_()
            bank = engines['fg'](sg, lmax, cg, xg, mesh, ell=ell)
            gl = local(np.moveaxis(prob['gout'], 0, -1)).movedim(-1, 0)
            (bank * gl).sum().backward()
            out[key + 'cbar'] = cg.grad.cpu().numpy()
            out[key + 'xbar'] = xg.grad.cpu().numpy()
    return out


def grad_results(par, W, prob, configs, dev):
    """Every configuration's gradients on this rank, through the public
    engines under autograd: at each order of :data:`GRAD_ORDERS` the
    bank's c̄ and x̄ (``cbar<m>``, ``xbar<m>``) for the cotangent
    ``gbank``, the synthesis's c̄ and ȳ (``syn_cbar<m>``, ``ybar<m>``) of
    y = [x, 2x, ...] for ``gsyn``, and the matvec's x̄ (``mv_xbar``) for
    ``gmv``. c̄ is this rank's, as autograd gives it (every rank the
    whole c̄); x̄ and ȳ are its slices."""
    x, lmax = prob['x'], float(prob['lmax'])
    nf = prob[f'c{GRAD_ORDERS[0]}'].shape[0]
    y = np.stack([x * (f + 1) for f in range(nf)], -1)
    out = {}
    for name, kind, shape, layout in configs:
        mesh, sg, ell, engines, place, local = configure(
            par, W, x, kind, shape, layout, dev)
        key = f'{name}__'
        out[key + 'perm'] = sg.perm.cpu().numpy()
        out[key + 'place'] = place
        xl, yl = local(x), local(y)
        gbank = local(np.moveaxis(prob['gbank'], 0, -1)).movedim(-1, 0)
        for m in GRAD_ORDERS:
            c = torch.tensor(prob[f'c{m}'], device=dev)
            cg, xg = c.clone().requires_grad_(), xl.clone().requires_grad_()
            bank = engines['op'](sg, lmax, cg, xg, mesh, ell=ell)
            grads = torch.autograd.grad(bank, (cg, xg), gbank)
            out[f'{key}cbar{m}'], out[f'{key}xbar{m}'] = (
                g.cpu().numpy() for g in grads)
            if has_synthesis(kind, layout):
                cg = c.clone().requires_grad_()
                yg = yl.clone().requires_grad_()
                s = engines['syn'](sg, lmax, cg, yg, mesh, ell=ell)
                grads = torch.autograd.grad(s, (cg, yg), local(prob['gsyn']))
                out[f'{key}syn_cbar{m}'], out[f'{key}ybar{m}'] = (
                    g.cpu().numpy() for g in grads)
        xg = xl.clone().requires_grad_()
        (mv_xbar,) = torch.autograd.grad(engines['mv'](sg, xg, mesh, ell=ell),
                                         (xg,), local(prob['gmv']))
        out[key + 'mv_xbar'] = mv_xbar.cpu().numpy()
    return out


def run(rank, world, work, device='cpu', mode='engines'):
    from pygsp_tpu_torch import parallel as par
    from pygsp_tpu_torch.parallel.mesh import _default_device

    par.initialize(f'file://{os.path.join(work, "rendezvous")}', world,
                   rank, device=device)
    prob = np.load(os.path.join(work, 'problem.npz'))
    W = sps.csr_matrix((prob['w_data'], prob['w_indices'],
                        prob['w_indptr']))
    dev = _default_device(rank, device)          # this rank's device
    results = grad_results if mode == 'grad' else engine_results
    out = results(par, W, prob, CONFIGS[world], dev)
    np.savez(os.path.join(work, f'rank{rank}.npz'), **out)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    torch.set_num_threads(1)
    flags = sys.argv[4:]
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
        'cuda' if 'cuda' in flags else 'cpu',
        'grad' if 'grad' in flags else 'engines')
