"""Wall seconds of prime-dual solves on the card, to compare two trees.

    python scripts/solve_times.py [--sizes 3654 9190] [--epoch-pd 2000]
    PYTHONPATH=<other tree> python scripts/solve_times.py   # that tree's

Each solve runs `jamie_tpu_torch.solvers.prime_dual.prime_dual` as a fit
calls it at the defaults (precision 'default': bf16 operands, f32 result;
f32 state) on distance-shaped operands (`probes.distance_operand`, seeds 0
and 1), timed from the call to a synchronize after a 10-iteration solve
of the same shape has built everything. Then the 2048^2 solve of
chip_smoke.py's phase K on a world-size-1 ('data',) mesh, captured with its
collectives and op by op (`_eager=True`), beside the same solve without
the mesh. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from jamie_tpu_torch.core import mesh as cm
from jamie_tpu_torch.probes import distance_operand
from jamie_tpu_torch.solvers.prime_dual import prime_dual


def timed_solve(Kx, Ky, epoch_pd, **kw):
    prime_dual(Kx, Ky, dx=32, dy=32, epoch_pd=10, verbose=False, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    prime_dual(Kx, Ky, dx=32, dy=32, epoch_pd=epoch_pd, verbose=False,
               **kw)
    torch.cuda.synchronize()
    return round(time.perf_counter() - t, 4)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--sizes', type=int, nargs='+', default=[3654, 9190])
    p.add_argument('--epoch-pd', type=int, default=2000)
    p.add_argument('--mesh-size', type=int, default=2048)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('solve_times: needs a CUDA card')
    dev = torch.device('cuda')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {'epoch_pd': args.epoch_pd, 'solve_s': {}}
    for n in args.sizes:
        Kx, Ky = distance_operand(n, 0, dev), distance_operand(n, 1, dev)
        out['solve_s'][n] = timed_solve(Kx, Ky, args.epoch_pd)
        del Kx, Ky
        torch.cuda.empty_cache()
    n = args.mesh_size
    Kx, Ky = distance_operand(n, 0, dev), distance_operand(n, 1, dev)
    mesh = cm.create_mesh((1,), ('data',))
    try:
        out['mesh'] = {'size': n,
                       'plain_s': timed_solve(Kx, Ky, args.epoch_pd),
                       'mesh_s': timed_solve(Kx, Ky, args.epoch_pd,
                                             mesh=mesh),
                       'mesh_eager_s': timed_solve(Kx, Ky, args.epoch_pd,
                                                   mesh=mesh, _eager=True)}
    finally:
        cm.destroy_group()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
