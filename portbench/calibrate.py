"""The readings that the limits of ``limits/<cell>.json`` are set from,
many seeds in one process (the benchmark's own runs do not run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --side program
    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --side control

``program``: one run of the cell a seed (``core/cellrun.py``
``run_cell``, a window of ``--seconds``), its ``numbers``: the timed
path's answers for the segment that the seed draws, compared with the
float64 reference as every run compares them. ``control``: the reference itself in float32
with every matrix product's operands rounded to TF32 (the precision
below the configuration's float32 with TF32 off) put in the program's
place. ``plain32``: the reference in float32 without TF32 (the port's
plain path in the configuration's precision: a witness of what float32
alone costs against float64). Prints one JSON line a seed: the compared
numbers.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_answers(s, dev, inputs, tr, tf32=True):
    """The answers of the sampled segment's first and last chunk from
    the reference in float32 with TF32 products, or without them
    (``tf32=False``), put in the program's place, its gate its own (no
    chunk redone on the program's word)."""
    import torch

    from core.check import Answer, run_chunk
    from core.cellrun import _host
    from reference.model import Fields, Reference

    ctl = Reference(s, dev, dtype=torch.float32, tf32=tf32)
    dt, chunk = float(tr["dt"]), int(tr["chunk"])
    per_seg = int(tr["segment"]) // chunk
    f = Fields(*(x.float() if torch.is_tensor(x)
                 else tuple(t.float() for t in x) for x in inputs))
    out = {}
    for k in range(per_seg):
        f, ok, diag = run_chunk(ctl, f, dt, chunk)
        if k in (0, per_seg - 1):
            out[k] = Answer(_host(f), diag, float(ok))
    return out, [False] * per_seg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control", "plain32"),
                    required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window of each program run")
    ap.add_argument("--grid", default=None,
                    help="another grid, e.g. 8,16,32 (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import time

    import torch

    from core import check, spec
    from core.cellrun import run_cell
    from core.inputs import make_inputs
    from reference.model import WORKING, Reference, settings

    cell = spec.cell(args.workload)
    tr = cell.traffic
    if args.grid:
        tr = dict(tr, grid=[int(n) for n in args.grid.split(",")])
    dev = torch.device(args.device)
    s = settings(cell.config, tr["grid"])
    wd = WORKING[s.working]
    for seed in (int(x) for x in args.seeds.split(",")):
        if args.side == "program":
            out = run_cell(cell._replace(traffic=tr), seed, args.seconds,
                           False, dev, time.perf_counter())
            numbers, extra = out["numbers"], {
                "redone": out["redone"],
                "escalations": out["run"].escalations}
        else:
            grid = Reference(s, dev, dtype=wd, tables=False)
            inputs = make_inputs(grid, tr["seed_rule"], seed, wd)
            answers, redone = control_answers(s, dev, inputs, tr,
                                              tf32=args.side == "control")
            numbers = check.reference_gaps(
                Reference(s, dev, dtype=torch.float64), inputs,
                float(tr["dt"]), int(tr["chunk"]), answers, redone)
            extra = {}
        print(json.dumps({"cell": cell.name, "side": args.side,
                          "seed": seed, **numbers, **extra}), flush=True)


if __name__ == "__main__":
    main()
