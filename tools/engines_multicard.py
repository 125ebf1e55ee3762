"""The multi-device engines across cards: every configuration of
``tests/_torch_distributed_worker.py`` at one world size on NCCL, one
process per card, held to the port's single-device bank in float64.

The CPU tests run the same configurations under gloo
(``tests/test_torch_parallel.py``); this runs them on the cards, where the
halo's ``batch_isend_irecv``, the 2-D ring shifts, ``all_gather_into_tensor``
and ``reduce_scatter_tensor`` go over NCCL. The problem is the tests' (an
``StochasticBlockModel(N=192, k=3, seed=0)`` heat bank, x (N, 4), f64),
written to a work directory; each rank's slices are assembled and held,
within 1e-12 of the largest value, to ``cheby_op``, ``cheby_synthesis``
and the fixed-graph VJP on one device (the CPU), and the bf16 modes within
twice ``carry_error_estimate``. On the cards, each 2-D ring layout's
matvec must launch the fused multi-matrix SpMM (``fold_strip_multi``)
twice at fold position 0 (ring step 0 alone, under the row shifts, then
steps 1..pr−1) and once at each later position of the interleaved ring
(pc + 1 in all; 2 on the plain ring), and no fold into a window tensor,
no strip and no single-matrix fold. Then the worker's ``grad`` mode runs
the engines under autograd on the same configurations at orders 12 and 30:
each rank's c̄ (every rank the whole c̄) and the assembled x̄ of the bank,
the synthesis's c̄ and ȳ, and the matvec's x̄, held within 1e-12 of the
largest value to the port's single-device ``cheby_op``, ``cheby_synthesis``
and ``L @ x`` under autograd on the CPU (the ``grad`` keys). One JSON line
per configuration, then a summary line.

Run: ``python3 tools/engines_multicard.py [world]`` (default 4, one card a
rank; ``--cpu`` for gloo on the CPU instead).
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sps
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

from _torch_distributed_worker import (CARRY, CONFIGS,  # noqa: E402
                                       GRAD_ORDERS, LAUNCHED, VJP, assemble,
                                       has_synthesis)

import pygsp_tpu_torch as gsp  # noqa: E402
from pygsp_tpu_torch.ops import chebyshev as cheby  # noqa: E402

TOL = 1e-12
DEADLINE_S = 300


def problem():
    G = gsp.graphs.StochasticBlockModel(N=192, k=3, seed=0, device='cpu',
                                        dtype=torch.float64)
    W = sps.csr_matrix(G.W)
    Ls = sps.diags(np.ravel(W.sum(axis=1))) - W
    lmax = 1.01 * float(sps.linalg.eigsh(Ls, k=1, which='LA')[0][0])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(G.N, 4))
    G._lmax = lmax
    c = cheby.cheby_coeff(gsp.filters.Heat(G, scale=[5.0, 20.0]).evaluate,
                          lmax, m=12, dtype=torch.float64,
                          device='cpu').numpy()
    gout = rng.normal(size=(2, G.N, 4))
    grad = {f'c{m}': cheby.cheby_coeff(
        gsp.filters.Heat(G, scale=[5.0, 20.0]).evaluate, lmax, m=m,
        dtype=torch.float64, device='cpu').numpy() for m in GRAD_ORDERS}
    grng = np.random.default_rng(21)
    grad.update(gbank=grng.normal(size=(2, G.N, 4)),
                gsyn=grng.normal(size=(G.N, 4)),
                gmv=grng.normal(size=(G.N, 4)))
    return G, W, Ls, lmax, x, c, gout, grad


def reference(G, Ls, lmax, x, c, gout):
    """The port's single-device bank, matvec, synthesis and VJP in f64 on
    the CPU."""
    nf = c.shape[0]
    y = np.stack([x * (f + 1) for f in range(nf)], -1)
    ct = torch.tensor(c, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    bank = cheby.cheby_op_fixed_graph(G.L, lmax, ct, xt)
    (bank * torch.tensor(gout)).sum().backward()
    return dict(fwd=bank.detach().numpy(), mv=Ls @ x,
                syn=cheby.cheby_synthesis(G.L, lmax, torch.tensor(c),
                                          torch.tensor(y)).numpy(),
                cbar=ct.grad.numpy(), xbar=xt.grad.numpy())


def grad_reference(G, lmax, x, grad):
    """The port's single-device gradients in f64 on the CPU, under
    autograd: the bank's and the synthesis's (of y = [x, 2x, ...]) c̄ and
    x̄ or ȳ at each order, and ``L @ x``'s x̄, under the worker's ``grad``
    mode's names."""
    out = {}
    xt = torch.tensor(x)
    y = torch.stack([xt * (f + 1) for f in range(grad['gbank'].shape[0])],
                    -1)
    for m in GRAD_ORDERS:
        c = torch.tensor(grad[f'c{m}'])
        for key, fn, sig, cot in (
                ('', cheby.cheby_op, xt, grad['gbank']),
                ('syn_', cheby.cheby_synthesis, y, grad['gsyn'])):
            ct, st = c.clone().requires_grad_(), sig.clone().requires_grad_()
            cbar, sbar = torch.autograd.grad(fn(G.L, lmax, ct, st), (ct, st),
                                             torch.tensor(cot))
            out[f'{key}cbar{m}'] = cbar.numpy()
            out[f'{"ybar" if key else "xbar"}{m}'] = sbar.numpy()
    xg = xt.clone().requires_grad_()
    (out['mv_xbar'],) = (v.numpy() for v in torch.autograd.grad(
        G.L @ xg, (xg,), torch.tensor(grad['gmv'])))
    return out


def spawn(world, work, device, mode):
    """Run the worker's ranks in ``mode`` and return each rank's results;
    exits where a rank fails or misses its deadline."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tests',
                                      '_torch_distributed_worker.py'),
         str(r), str(world), work, device, mode], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise SystemExit(f'{mode}: a rank did not finish in '
                             f'{DEADLINE_S} s')
        if p.returncode:
            for q in procs:
                q.kill()
            raise SystemExit(f'{mode}: a rank failed:\n{err[-4000:]}')
    return [dict(np.load(os.path.join(work, f'rank{r}.npz')))
            for r in range(world)]


def grad_errors(parts, ref, name, kind, layout):
    """A configuration's gradients against the single-device ones:
    relative errors by name, c̄ the worst rank's."""
    keys = [f'xbar{m}' for m in GRAD_ORDERS] + ['mv_xbar']
    cbars = [f'cbar{m}' for m in GRAD_ORDERS]
    if has_synthesis(kind, layout):
        keys += [f'ybar{m}' for m in GRAD_ORDERS]
        cbars += [f'syn_cbar{m}' for m in GRAD_ORDERS]
    errs = {k: float(np.abs(assemble(parts, name, k) - ref[k]).max()
                     / np.abs(ref[k]).max()) for k in keys}
    errs.update({k: max(float(np.abs(p[f'{name}__{k}'] - ref[k]).max()
                              / np.abs(ref[k]).max()) for p in parts)
                 for k in cbars})
    return errs


def expected_launches(kind, shape, layout, device):
    """A rank's launches in one matvec of a 2-D ring layout on the cards
    (pr > 1): the fused SpMM twice at fold position 0 (step 0 alone, then
    the rest) and once at each later one, and no fold into a window
    tensor, strip or single-matrix fold; None where no count is
    required."""
    pr, pc = shape
    if device != 'cuda' or kind != '2d' or not layout.startswith('ring') \
            or pr == 1:
        return None
    n = 1 + (pc if layout.endswith('split') else 1)
    return dict(fold_strip_multi=n, windowed_fold_multi=0, windowed_fold=0,
                window_strip=0)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith('--')]
    world = int(args[0]) if args else 4
    device = 'cpu' if '--cpu' in sys.argv else 'cuda'
    if device == 'cuda' and torch.cuda.device_count() < world:
        print(f'engines_multicard: {world} ranks need {world} cards, found '
              f'{torch.cuda.device_count()}', file=sys.stderr)
        sys.exit(1)
    G, W, Ls, lmax, x, c, gout, grad = problem()
    ref = reference(G, Ls, lmax, x, c, gout)
    gref = grad_reference(G, lmax, x, grad)
    est = cheby.carry_error_estimate(c, torch.bfloat16)
    with tempfile.TemporaryDirectory() as work:
        for mode in ('engines', 'grad'):     # a rendezvous file each
            os.mkdir(os.path.join(work, mode))
            np.savez(os.path.join(work, mode, 'problem.npz'), w_data=W.data,
                     w_indices=W.indices, w_indptr=W.indptr, x=x, c=c,
                     lmax=np.float64(lmax), gout=gout, **grad)
        parts = spawn(world, os.path.join(work, 'engines'), device,
                      'engines')
        gparts = spawn(world, os.path.join(work, 'grad'), device, 'grad')
    worst = {}
    for name, kind, shape, layout in CONFIGS[world]:
        errs = {}
        for key in ('fwd', 'mv', 'syn', 'xbar'):
            if f'{name}__{key}' in parts[0]:
                got, want = assemble(parts, name, key), ref[key]
                errs[key] = float(np.abs(got - want).max()
                                  / np.abs(want).max())
        if name in VJP:
            errs['cbar'] = max(float(np.abs(p[f'{name}__cbar'] - ref['cbar'])
                                     .max() / np.abs(ref['cbar']).max())
                               for p in parts)
        if name in CARRY:
            got = assemble(parts, name, 'bf16')
            errs['bf16'] = float(np.abs(got - ref['fwd']).max()
                                 / np.abs(ref['fwd']).max())
        gerrs = grad_errors(gparts, gref, name, kind, layout)
        ok = all(v <= (2 * est if k == 'bf16' else TOL)
                 for k, v in {**errs, **gerrs}.items())
        launches = [dict(zip(LAUNCHED, p[f'{name}__launches'].tolist()))
                    for p in parts]
        want = expected_launches(kind, shape, layout, device)
        if want:
            ok = ok and all(n == want for n in launches)
        worst[name] = ok
        print(json.dumps({'config': name, 'mesh': shape, 'layout': layout,
                          'rel_err': errs, 'grad_rel_err': gerrs,
                          'grad_worst': max(gerrs.values()),
                          'launches': launches[0],
                          'launches_expected': want, 'ok': ok}), flush=True)
    print(json.dumps({'world': world, 'device': device,
                      'backend': 'nccl' if device == 'cuda' else 'gloo',
                      'bf16_bound': 2 * est, 'ok': all(worst.values()),
                      'configs': len(worst)}), flush=True)
    if not all(worst.values()):
        sys.exit(1)


if __name__ == '__main__':
    main()
