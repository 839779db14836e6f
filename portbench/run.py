"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json`` and its files under portbench/
(configs/, traffic/, limits/, metrics/), runs the port
(``dycoreplanet_tpu_torch``) on one card, checks what the window produced
against the plain reference (portbench/reference/), and prints one JSON
line last on standard output: the end-to-end metrics with ``--trace 0``,
the per-layer ones with ``--trace 1``. Exits with 1 and prints no result
without a card, with fewer cards than the cell asks for, or when the
process holds JAX, flax or the JAX package once the window has closed.
See portbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")

FORBIDDEN = ("jax", "jaxlib", "flax", "dycoreplanet_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``dycoreplanet_tpu_torch`` is not ``dycoreplanet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from core import check, spec
    from core.cellrun import run_cell

    if not os.path.exists(os.path.join(ROOT, "dycoreplanet_tpu_torch")):
        fail("the port (dycoreplanet_tpu_torch) is not beside portbench/")
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        fail("the process holds " + ", ".join(found))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["run"].peak_bytes}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        line["breakdown"] = out["breakdown"]
    line["check"] = {k: {"value": out["numbers"][k],
                         "limit": cell.limits[k]} for k in check.NUMBERS}
    print(json.dumps(line), flush=True)
    for text in check.lines(out["numbers"], cell.limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()


if __name__ == "__main__":
    main()
