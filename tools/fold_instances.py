"""Times the windowed fold's instances at path C's shape on the card.

For the package found first on the import path (so that two copies of it
can be compared, each run with its own ``PYTHONPATH``), on ``chip_smoke.py``'s
path C (the bench graph in the windowed format, x (N, 128)), in the
matrix's internal order: ms per launch (CUDA events, 20 launches) of the
fold with x and values in bf16 (path D's instance), with a bf16 x and f32
values, and in f32; the bf16 instance's largest distance from its plain
version in bf16 ulps; a hash of each instance's window tensor (two copies
that round alike give the same hashes); and ms per bank of path D. Prints one
JSON line.

Run: ``PYTHONPATH=<copy> python3 tools/fold_instances.py`` on a machine
with one CUDA device.
"""

import hashlib
import json
import os
import sys

import torch

# the repo root last, so that a copy of the package on PYTHONPATH wins
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pygsp_tpu_torch  # noqa: E402
from pygsp_tpu_torch.core import chunked  # noqa: E402
from pygsp_tpu_torch.core import windowed_kernel as wk  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit('fold_instances: no CUDA device available')
    _, g, x, _ = chip_smoke.path_c()
    M = g.G.L.offdiag
    xp = chunked.permute_in(M, x)
    out = {'package': os.path.dirname(pygsp_tpu_torch.__file__)}
    for name, xd, vd in (('both', torch.bfloat16, torch.bfloat16),
                         ('carry', torch.bfloat16, torch.float32),
                         ('f32', torch.float32, torch.float32)):
        args = (M.cols, M.vals.to(vd), M.rowid, xp.to(xd).contiguous(),
                M.chunk_rows, M.borrow_span * M.window_rows)
        t = wk.windowed_fold(*args)
        key = 'sha' if name == 'both' else f'{name}_sha'
        out[key] = hashlib.sha256(
            t.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
        if name == 'both':
            out['ulps_vs_plain'] = chip_smoke.ulps(
                t, wk.windowed_fold_plain(*args))
        del t
        out[f'{name}_ms'] = chip_smoke.time_ms(
            lambda: wk.windowed_fold(*args), 20)
    out['bank_D_ms'] = chip_smoke.time_ms(chip_smoke.fast_bank(g, x), 3)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
