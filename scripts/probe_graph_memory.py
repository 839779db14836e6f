#!/usr/bin/env python3
"""Device memory held by multi_step's CUDA graphs as they are captured,
kept and dropped (models/graphs.py).

    python3 scripts/probe_graph_memory.py [--cycles 6]

Runs the flagship configuration (models/presets.py: shell 32x128x256
f32, bench opt-ins, seeded developed flow) on CUDA and reads
`torch.cuda.memory_allocated` and `memory_reserved` (MiB) after:
  * the model and its state;
  * the first 20-step chunk (warm-up, capture, replay) and a second key
    (the same chunk without collected diagnostics);
  * with the cap (`ChunkGraphs.max_graphs`) set to 1, `--cycles` chunks
    alternating between a 10-step chunk and the 20-step one, each a
    capture that drops the other graph;
  * dropping every graph of the model.
Every chunk's returned state is dropped before a reading, so a reading
holds the model, its state and the kept graphs. Beside each, the bytes
of the kept graphs' own input and output buffers. The last line of
standard output is one JSON object with the readings. Needs one CUDA
card.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_graph_memory: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    model = BoussinesqModel(bench_params(), device="cuda")
    s0 = seed_developed_flow(model)
    readings = []

    def read(what):
        gc.collect()
        torch.cuda.synchronize()
        graphs = model.chunk_graphs
        kept = 0 if graphs is None else len(graphs)
        buffers = 0 if graphs is None else sum(
            t.numel() * t.element_size() for c in graphs._chunks.values()
            for t in c.inputs + c.outputs)
        r = dict(what=what, kept=kept,
                 allocated_mib=torch.cuda.memory_allocated() / 2**20,
                 reserved_mib=torch.cuda.memory_reserved() / 2**20,
                 graph_buffers_mib=buffers / 2**20)
        readings.append(r)
        print(f"{what:44s} kept {kept}  allocated {r['allocated_mib']:9.1f}"
              f"  reserved {r['reserved_mib']:9.1f}  graph buffers "
              f"{r['graph_buffers_mib']:7.1f} MiB", flush=True)

    def chunk(n, collect):
        model.multi_step(s0, BENCH_DT, n, collect_diagnostics=collect)

    read("model and state")
    chunk(20, True)
    read("20-step chunk (1st key)")
    chunk(20, False)
    read("20-step chunk, no diagnostics (2nd key)")
    model.chunk_graphs.max_graphs = 1
    for i in range(args.cycles):
        n, collect = (10, False) if i % 2 == 0 else (20, True)
        chunk(n, collect)
        read(f"cap 1, cycle {i + 1}: {n}-step chunk")
    captures = model.chunk_graphs.captures
    model.chunk_graphs = None
    read("every graph dropped")

    # the parts of a capture, each three times, a reading after each:
    # the eager chunk on the current stream, on a new side stream (the
    # warm-up), and captured into a graph that is dropped at once, in a
    # pool shared with a graph kept meanwhile, and in its own pool
    static = s0._replace(u=s0.u.clone(), u_faces=tuple(
        f.clone() for f in s0.u_faces), p=s0.p.clone(), T=s0.T.clone())

    def body():
        return model._chunk(static, BENCH_DT, 20, True, adaptive=False)

    for i in range(3):
        body()
        read(f"eager chunk, current stream ({i + 1})")
    for i in range(3):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        del side
        read(f"eager chunk, new side stream ({i + 1})")
    pool = torch.cuda.graph_pool_handle()
    held = torch.cuda.CUDAGraph()
    with torch.cuda.graph(held, pool=pool):
        held_out = body()
    read("a graph kept in the shared pool")
    for shared in (True, False):
        for i in range(3):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool if shared else None):
                out = body()
            del g, out
            read(f"capture dropped, {'shared' if shared else 'own'} pool "
                 f"({i + 1})")
    del held, held_out
    read("the kept graph dropped")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "captures": captures, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
