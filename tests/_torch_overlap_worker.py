"""One rank of the overlap tests' two-rank run (gloo on the CPU).

Run by ``tests/test_torch_overlap.py`` as ``python _torch_overlap_worker.py
<rank> <world> <work dir>``: it joins a gloo group through a file under the
work dir, then

- posts and waits for ring shifts (:func:`~pygsp_tpu_torch.parallel.mesh.
  ppermute_post`, :func:`~.mesh.ppermute_wait`) and a chain of them
  (:func:`~.mesh.ppermute_chain_post`), and keeps what it received, whether
  a shift of 0 came back as the tensor itself, and whether a second wait
  raised;
- runs the 1-D engine's product (:meth:`~pygsp_tpu_torch.parallel.sharded.
  _Shard.product`: the interior folded between the halo's post and its
  wait) and the same sums with the wait before the interior fold, on both
  split layouts in float64 and float32,

and writes it all to ``rank<r>.npz``. It imports torch and the port only.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scipy.sparse as sps  # noqa: E402
import torch  # noqa: E402

# the sent tensor of rank r: SHAPE values from r·1000
SHAPE = (6, 3)


def sent(rank):
    return torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float64).reshape(
        SHAPE) + 1000.0 * rank


def graph():
    """A ring of 64 vertices with chords: every shard has a halo."""
    n = 64
    src = np.concatenate([np.arange(n), np.arange(0, n, 3)])
    tgt = np.concatenate([(np.arange(n) + 1) % n, (np.arange(0, n, 3) + 29)
                          % n])
    W = sps.coo_matrix((np.ones(len(src)), (src, tgt)), shape=(n, n))
    return (W + W.T).tocsr()


def post_then_wait(sh, t2, out_dtype):
    """The 1-D split product with the halo waited for before any fold."""
    from pygsp_tpu_torch.parallel import sharded
    recv = sharded._halo_join(t2, sh.post(t2))
    interior, boundary = sh.mats
    y = sharded._product(interior, t2, out_dtype)
    if boundary is not None:
        if isinstance(sh.ell[0], sharded.ShardedELL):
            recv = torch.cat([t2, recv])
        y = y + sharded._product(boundary, recv, out_dtype)
    return y


def run(rank, world, work):
    from pygsp_tpu_torch import parallel as par
    from pygsp_tpu_torch.parallel import mesh as pm
    from pygsp_tpu_torch.parallel.sharded import _Shard

    par.initialize(f'file://{os.path.join(work, "rendezvous")}', world,
                   rank, device='cpu')
    mesh = par.make_mesh(world, 1, devices='cpu')
    out = {}
    t = sent(rank)
    handle = pm.ppermute_post(mesh, 'graph', [(1, t), (0, t)])
    got = pm.ppermute_wait(handle)
    out['shift1'] = got[0].numpy()
    out['shift0_is_the_tensor'] = got[1] is t
    try:
        pm.ppermute_wait(handle)
        out['second_wait_raised'] = False
    except RuntimeError:
        out['second_wait_raised'] = True
    out['ppermute'] = pm.ppermute(mesh, 'graph', [(1, t)])[0].numpy()
    chain = pm.ppermute_wait(pm.ppermute_chain_post(mesh, 'graph', t,
                                                    world))
    out['chain'] = np.stack([c.numpy() for c in chain])

    W = graph()
    for dtype in (np.float64, np.float32):
        sg = par.partition_graph(W, world, dtype=dtype, device='cpu')
        layouts = {'win_split': par.shard_local_windowed(
                       sg, split_boundary=True),
                   'ell_split': par.shard_local_ell(sg, split_boundary=True)}
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            (sg.n_local, 5)).astype(dtype))
        for name, ell in layouts.items():
            sh = _Shard(sg, mesh, ell)
            key = f'{name}_{np.dtype(dtype).name}'
            out[f'{key}_halo'] = sg.halo_total
            out[f'{key}_overlapped'] = sh.product(x, x.dtype).numpy()
            out[f'{key}_waited'] = post_then_wait(sh, x, x.dtype).numpy()
    np.savez(os.path.join(work, f'rank{rank}.npz'), **out)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    torch.set_num_threads(1)
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
