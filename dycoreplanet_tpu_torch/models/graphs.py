"""CUDA graphs of ``BoussinesqModel.multi_step`` chunks — the PyTorch form
of the JAX package's jitted ``lax.scan`` of the gated step
(dycoreplanet_tpu/models/boussinesq.py multi_step).

The eager step is bound by the host: ~120 launches a step from Python
against ~0.7 ms of device time (PERF.md). A chunk with a fixed dt that
runs no CG is captured once into a ``torch.cuda.CUDAGraph`` and then
replayed, one host launch a chunk:

  * the body is the model's own eager chunk (``BoussinesqModel._chunk``),
    run once on a side stream before the capture, as PyTorch's graph API
    requires; that warm-up also builds every constant and table the
    chunk reads (K1's 1/D tables, the metric caches, the diagnostics'
    constants), so that the capture makes no host-to-device copy. One
    side stream serves every capture of the model: PyTorch keeps a
    cuBLAS workspace (32 MiB on the H100) for each stream that ran a
    matrix product, for the life of the process;
  * a graph is keyed by the chunk length, the phase of ``step_number``
    modulo lcm(``NSE solver interval``, ``residual check interval``)
    (which steps are temperature substeps, which take K1's
    residual-free variant), ``collect_diagnostics``, the Helmholtz path
    and dt (the kernels take dt as a host double: another dt is another
    graph);
  * at most ``max_graphs`` graphs are kept, so that a run whose keys
    change (a last, shorter chunk, another dt) does not grow without
    bound: after a capture the least recently replayed graphs beyond
    that are dropped, and their outputs' memory returns to the pool for
    later captures. They are dropped only after the new capture, as the
    allocator refuses a capture into a shared pool that no live graph
    holds;
  * the state is copied into the graph's own input buffers before a
    replay and its outputs are cloned after it (2 dim + 1 field copies a
    chunk: u, the dim face velocities, p, T; the packed rows),
    so that neither the caller's state nor the input a retry needs is
    the graph's memory;
  * all graphs of one model share one memory pool: a graph's outputs are
    read right after its replay, before another graph runs;
  * K1's 1/D tables depend on dt and are refilled in place for the
    graph's dt before each replay (``BoussinesqModel._prepare_dt``).

A replay calls no kernel wrapper, so the wrappers' ``launches`` count
the warm-up's and the capture's calls only; the kernels a replay runs
are counted on the device (``diagnostics.device_time.device_launches``).
A failed capture raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

# graphs kept per model: a run of fixed-length chunks needs one per phase
# its chunks start at (one when the chunk length is a multiple of the
# intervals' lcm), plus one for a last, shorter chunk
MAX_GRAPHS = 8


class CapturedChunk(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]     # u, the dim faces, p, T
    outputs: Tuple[torch.Tensor, ...]    # u, the dim faces, p, T, packed


def _fields(state) -> Tuple[torch.Tensor, ...]:
    return (state.u,) + tuple(state.u_faces) + (state.p, state.T)


def _with_fields(state, fields):
    """``state`` holding ``fields`` (u, the faces, p, T, as _fields)."""
    return state._replace(u=fields[0], u_faces=tuple(fields[1:-2]),
                          p=fields[-2], T=fields[-1])


class ChunkGraphs:
    """The captured chunks of one model on the card, least recently
    replayed first. ``captures`` and ``replays`` count graphs made and
    replayed."""

    def __init__(self, model):
        self.model = model
        self.max_graphs = MAX_GRAPHS
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device=model.device)
        self._chunks: Dict[tuple, CapturedChunk] = {}
        self.captures = 0
        self.replays = 0

    def key(self, state, dt: float, n_steps: int, collect: bool) -> tuple:
        m = self.model
        period = math.lcm(m.params.NSE_solver_interval,
                          m.params.numerics.residual_check_interval)
        return (n_steps, state.step_number % period, bool(collect),
                m.helmholtz_direct is not None, m._scalar(dt))

    def _capture(self, state, dt: float, n_steps: int,
                 collect: bool) -> CapturedChunk:
        m = self.model
        dev = m.device
        inputs = tuple(f.clone() for f in _fields(state))
        static = _with_fields(state, inputs)

        def body():
            s, packed, _ = m._chunk(static, dt, n_steps, collect,
                                    adaptive=False)
            return _fields(s) + (packed,)

        self.side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.side):
            body()
        torch.cuda.current_stream(dev).wait_stream(self.side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            outputs = body()
        self.captures += 1
        return CapturedChunk(graph, inputs, outputs)

    def run(self, state, dt: float, n_steps: int, collect: bool):
        """One chunk by graph replay: (state, packed, dt) as
        ``BoussinesqModel._chunk`` returns them."""
        m = self.model
        key = self.key(state, dt, n_steps, collect)
        chunk = self._chunks.pop(key, None)
        if chunk is None:
            chunk = self._capture(state, dt, n_steps, collect)
        self._chunks[key] = chunk              # the most recent, last
        while len(self._chunks) > self.max_graphs:
            del self._chunks[next(iter(self._chunks))]
        m._prepare_dt(dt)
        for dst, src in zip(chunk.inputs, _fields(state)):
            dst.copy_(src)
        chunk.graph.replay()
        self.replays += 1
        *fields, packed = (t.clone() for t in chunk.outputs)
        time = state.time
        dt_T = m._dt_T(dt)
        for _ in range(n_steps):            # as each eager step adds it
            time = m._advance_time(time, dt_T)
        new = _with_fields(state, fields)._replace(
            time=time, step_number=state.step_number + n_steps)
        return new, packed, m._scalar(dt)

    def __len__(self) -> int:
        return len(self._chunks)
