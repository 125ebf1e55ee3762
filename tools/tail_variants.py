"""Times the windowed SpMM's tail (``window_strip`` with the residue list)
at path C's shape on the card.

For the package found first on the import path (so that copies of it that
differ in the kernel's constants can be compared, each run with its own
``PYTHONPATH``), on ``chip_smoke.py``'s path C (the bench graph in the
windowed format, x (N, 128), the matrix's internal order): the kernel's
registers and spills (``nvcc -Xptxas -v``, if this copy is not built yet);
ms per launch (CUDA events, 20 launches) of the tail in f32 and in bf16
(x and values, path D's instance), of the strip alone and of the tail
with the heavy rows' entries alone (the strip and the heavy blocks); and a
hash of each y (copies that sum alike give the same hashes). Prints one
JSON line.

Run: ``PYTHONPATH=<copy> python3 tools/tail_variants.py`` on a machine with
one CUDA device. The tail with no heavy blocks (every row left to the row
groups) is a copy whose ``kHeavyMin`` (``csrc/windowed_fold.cu``) and
``TAIL_HEAVY_ENTRIES`` (``core/windowed_kernel.py``) are both set above
every row's count, for example::

    mkdir -p .smoke_tree/no_heavy
    cp -r pygsp_tpu_torch .smoke_tree/no_heavy/
    sed -i 's/kHeavyMin = 8;/kHeavyMin = 1 << 30;/' \
        .smoke_tree/no_heavy/pygsp_tpu_torch/csrc/windowed_fold.cu
    sed -i 's/^TAIL_HEAVY_ENTRIES = 8$/TAIL_HEAVY_ENTRIES = 1 << 30/' \
        .smoke_tree/no_heavy/pygsp_tpu_torch/core/windowed_kernel.py
    PYTHONPATH=$PWD/.smoke_tree/no_heavy python3 tools/tail_variants.py
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
from pygsp_tpu_torch.core import _cuda, chunked  # noqa: E402
from pygsp_tpu_torch.core import windowed_kernel as wk  # noqa: E402


def sha(y):
    return hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def heavy_only(res, n_rows):
    """The residue list with the entries of its heavy rows alone."""
    dev = res.rowptr.device
    counts = res.rowptr[1:] - res.rowptr[:-1]
    sizes = res.entptr[1:] - res.entptr[:-1]
    keep_row = counts >= wk.TAIL_HEAVY_ENTRIES
    keep_ent = torch.repeat_interleave(keep_row, counts.long(),
                                       output_size=sizes.numel())
    keep_slot = torch.repeat_interleave(keep_ent, sizes.long(),
                                        output_size=res.cols.numel())
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return res._replace(
        rowptr=torch.cat([zero, torch.where(keep_row, counts, 0).cumsum(
            0, dtype=torch.int32)]),
        entptr=torch.cat([zero, sizes[keep_ent].cumsum(0, dtype=torch.int32)]),
        cols=res.cols[keep_slot].contiguous(),
        vals=res.vals[keep_slot].contiguous())


def main():
    if not torch.cuda.is_available():
        sys.exit('tail_variants: no CUDA device available')
    out = {'package': os.path.dirname(pygsp_tpu_torch.__file__)}
    log = _cuda.build(['windowed_fold'], extra_flags=('-Xptxas', '-v'))
    lines = log.get('windowed_fold', '').splitlines()
    out['ptxas'] = [' '.join(l.strip() for l in lines[i + 2:i + 4])
                    for i, line in enumerate(lines)
                    if 'window_strip_kernel' in line and 'Compiling' in line]
    G, _, x, _ = chip_smoke.path_c()
    M = G.L.offdiag
    n, P = M.n_rows, M.window_rows
    for name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        Md = M.astype(dtype)
        xp = chunked.permute_in(Md, x).to(dtype).contiguous()
        t = wk.windowed_fold(Md.cols, Md.vals, Md.rowid, xp, M.chunk_rows,
                             M.borrow_span * P)
        res = Md.residue
        out[f'{name}_heavy_rows'] = res.heavy.numel()
        for key, r in (('tail', res), ('heavy_rows_only', heavy_only(res, n)),
                       ('strip_only', None)):
            y = wk.window_strip(t, n, P, r, xp)
            out[f'{name}_{key}_sha'] = sha(y)
            out[f'{name}_{key}_ms'] = chip_smoke.time_ms(
                lambda: wk.window_strip(t, n, P, r, xp), 20)
        del t, xp, Md
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
