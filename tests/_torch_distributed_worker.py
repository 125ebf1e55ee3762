"""One rank of the port's multi-process engine tests (gloo on the CPU).

Run by ``tests/test_torch_parallel.py`` as ``python
_torch_distributed_worker.py <rank> <world> <work dir>``: it joins a gloo
group through a file under the work dir, reads the problem the test wrote
(``problem.npz``: the adjacency, x, c, λmax), runs every engine
configuration of its world size on its slice of the signal, and writes its
slices, with what places them, and the kernel launches of its matvec to
``rank<r>.npz``. A fourth argument
``cuda`` runs it on the rank's card with NCCL instead
(``tools/engines_multicard.py``). It imports torch and the port only.
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


def assemble(parts, name, key):
    """The ranks' slices of ``key`` (from their ``rank<r>.npz``) placed in
    the padded signal and taken back to the original vertex order (vertex
    axis 1 for a bank)."""
    bank = key in ('fwd', 'bf16')
    perm = parts[0][f'{name}__perm']
    first = parts[0][f'{name}__{key}']
    n_local, cols = (int(v) for v in parts[0][f'{name}__place'][2:])
    n_parts = 1 + max(int(p[f'{name}__place'][0]) for p in parts)
    n_blocks = 1 + max(int(p[f'{name}__place'][1]) for p in parts)
    shape = (n_parts * n_local, n_blocks * cols)
    out = np.zeros((first.shape[0],) + shape if bank else shape)
    for p in parts:
        part, block = (int(v) for v in p[f'{name}__place'][:2])
        rows = slice(part * n_local, (part + 1) * n_local)
        cs = slice(block * cols, (block + 1) * cols)
        if bank:
            out[:, rows, cs] = p[f'{name}__{key}']
        else:
            out[rows, cs] = p[f'{name}__{key}']
    return out[:, perm] if bank else out[perm]


def launch_counts():
    """The launches so far of the windowed kernels that a 2-D ring layout
    takes (:data:`LAUNCHED`); all 0 on the CPU, where the wrappers run
    their plain versions."""
    from pygsp_tpu_torch.core import windowed_kernel as wk
    return np.array([getattr(wk, k).launches for k in LAUNCHED])


def run(rank, world, work, device='cpu'):
    from pygsp_tpu_torch import parallel as par
    from pygsp_tpu_torch.parallel.mesh import _default_device

    par.initialize(f'file://{os.path.join(work, "rendezvous")}', world,
                   rank, device=device)
    prob = np.load(os.path.join(work, 'problem.npz'))
    W = sps.csr_matrix((prob['w_data'], prob['w_indices'],
                        prob['w_indptr']))
    dev = _default_device(rank, device)          # this rank's device
    x, c, lmax = prob['x'], torch.tensor(prob['c'], device=dev), \
        float(prob['lmax'])
    nf, s_all = c.shape[0], x.shape[1]
    out = {}
    for name, kind, shape, layout in CONFIGS[world]:
        a, b = shape
        if kind == '1d':
            mesh = par.make_mesh(a, b, devices=dev)
            sg = par.partition_graph(W, a, dtype=np.float64, device=dev)
            ell = layout_1d(par, sg, layout)
            g_idx, b_idx = mesh.index('graph'), mesh.index('batch')
            if b > 1:      # this rank's own shard only, as a launch keeps it
                sg = par.put_sharded_graph(sg, mesh)
            part, block = g_idx, b_idx
            n_local = sg.n_local
            engines = dict(op=par.sharded_cheby_op,
                           syn=par.sharded_cheby_synthesis,
                           fg=par.sharded_cheby_op_fixed_graph,
                           mv=par.sharded_matvec)
        else:
            mesh = par.make_mesh_2d(a, b, devices=dev)
            sg = par.partition_graph_2d(W, a, b, dtype=np.float64,
                                        device=dev)
            ell = layout_2d(par, sg, layout)
            part, block, n_local = mesh.rank, 0, sg.n_local
            engines = dict(op=par.cheby_op_2d, syn=par.cheby_synthesis_2d,
                           fg=par.cheby_op_2d_fixed_graph,
                           mv=par.matvec_2d)
        cols = s_all // (b if kind == '1d' else 1)
        xp = sg.pad_signal(torch.tensor(x, device=dev))
        xl = xp[part * n_local:(part + 1) * n_local,
                block * cols:(block + 1) * cols].contiguous()
        key = f'{name}__'
        out[key + 'perm'] = sg.perm.cpu().numpy()
        out[key + 'place'] = np.array([part, block, n_local, cols])
        out[key + 'fwd'] = engines['op'](sg, lmax, c, xl, mesh,
                                         ell=ell).cpu().numpy()
        before = launch_counts()
        out[key + 'mv'] = engines['mv'](sg, xl, mesh,
                                        ell=ell).cpu().numpy()
        out[key + 'launches'] = launch_counts() - before
        if kind == '1d' or layout.startswith(('ring', 'mono')):
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
            gw = torch.tensor(prob['gout'], device=dev)
            gl = sg.pad_signal(gw.movedim(0, 1)).movedim(1, 0)[
                :, part * n_local:(part + 1) * n_local,
                block * cols:(block + 1) * cols]
            (bank * gl).sum().backward()
            out[key + 'cbar'] = cg.grad.cpu().numpy()
            out[key + 'xbar'] = xg.grad.cpu().numpy()
    np.savez(os.path.join(work, f'rank{rank}.npz'), **out)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    torch.set_num_threads(1)
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
        *sys.argv[4:5])
