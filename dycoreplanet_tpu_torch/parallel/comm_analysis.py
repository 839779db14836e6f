"""Communication accounting on the mesh (counterpart of the JAX
package's ``parallel/comm_analysis.py``).

The JAX package reads each collective's count and payload from the HLO
that its sharded step compiles to. The port has no HLO: every move of
data between shards is a call of ``parallel/halo.py``, and inside
:func:`counting` each such call reports itself as the collective the
JAX package compiles it to:

  collective-permute   ``_permute`` (the ghost exchanges built on it:
                       ``exchange_ghosts``, ``halo_pad``, ``lat_halo``,
                       ``row_halo``, ``col_halo``, ``pad_block``,
                       ``pad_mirror``) and the pole closure's half turn
                       (``half_turn``, ``pad_mirror``'s pole rows) where
                       it crosses shards;
  all-reduce           ``psum`` (so ``ShardedStep.total`` and ``dot``,
                       the Krylov loops' inner products and the sharded
                       solves' one field-sized sum) and ``pmax``;
  all-gather           ``windows``: a shard's window of the global grid,
                       other shards' interiors beyond a halo;
  all-to-all,          never made by the port (no transpose of a field
  reduce-scatter       across the mesh): counted so that a test can hold
                       them at 0.

Bytes are the JAX module's definition: the per-device receive payload
of one op (its result: one shard's block for a permute, the partial's
shape in the sum's dtype for an all-reduce, the window for a gather),
counted once per op. A gather is made one destination at a time, so its
count and bytes are the largest destination's. Payload between shards
on the same card counts (a transport across cards would move it); a
permute whose pairs all stay on their own shard (a ring of one shard,
an exchange along a mesh axis of one shard) moves nothing and is not
counted. Counts are of executed ops: the JAX counts are of HLO
instructions, where a loop body counts once, so a Krylov path's counts
grow with its iterations.

On a mesh that spans processes (parallel/mesh.py) every rank takes part
in every transport call and records it as one process records it (a
gather: every destination's part), so that each rank's ledger of a step
is the single-controller ledger. That ledger is the JAX module's count,
not what a process mesh moves: there ``psum`` and ``pmax`` are
all-gathers of every shard's partial (parallel/halo.py), so a rank
receives the partials of the other ranks' shards, A·B - A·B/W of them
where the ledger records one partial's bytes for an all-reduce. The
messages and bytes a rank actually sends and receives, the all-gathers'
included, are parallel/dist.py's ``stats``.

Outside :func:`counting` nothing is recorded: a transport call pays one
test of ``active``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

COLLECTIVE_OPS = ("all-reduce", "all-gather", "collective-permute",
                  "all-to-all", "reduce-scatter")


class Ledger:
    """The ops recorded inside one :func:`counting` block."""

    def __init__(self):
        self._ops = {op: [0, 0] for op in COLLECTIVE_OPS}
        self._by_dest: Dict[str, Dict[object, list]] = {}

    def record(self, op: str, nbytes: int, dest=None) -> None:
        """One op of ``op`` moving ``nbytes`` to every device, or (with
        ``dest``) one destination's part of an op made a destination at a
        time."""
        if dest is None:
            row = self._ops[op]
        else:
            row = self._by_dest.setdefault(op, {}).setdefault(dest, [0, 0])
        row[0] += 1
        row[1] += int(nbytes)

    def summary(self) -> Dict[str, Dict[str, int]]:
        """{op: {"count", "bytes"}} for every op of COLLECTIVE_OPS."""
        out = {}
        for op, (n, b) in self._ops.items():
            parts = self._by_dest.get(op, {}).values()
            out[op] = {"count": n + max((p[0] for p in parts), default=0),
                       "bytes": b + max((p[1] for p in parts), default=0)}
        return out


# the ledger of the innermost open counting() block, or None
active: Optional[Ledger] = None


def nbytes(t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> int:
    """The payload of ``t`` (in ``dtype``, where the op converts it)."""
    size = (torch.empty((), dtype=dtype).element_size() if dtype is not None
            else t.element_size())
    return t.numel() * size


@contextlib.contextmanager
def counting() -> Iterator[Ledger]:
    """Record every transport call of parallel/halo.py made inside the
    block; the yielded ledger's ``summary()`` reads them. Blocks nest:
    an inner block's ops are not the outer one's."""
    global active
    outer, active = active, Ledger()
    try:
        yield active
    finally:
        active = outer


def step_comm_summary(model, state, dt) -> Dict[str, Dict[str, int]]:
    """{op: {"count", "bytes"}} of one mesh step of ``model`` (prepared
    with ``prepare_sharded``) from the sharded ``state``: the JAX
    function's ``step_comm_summary`` for the port's executed ops."""
    with counting() as ledger:
        model.step(state, dt)
    return ledger.summary()
