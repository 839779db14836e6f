"""The process group of a mesh that spans processes (the counterpart of
``jax.distributed.initialize`` for the port's mesh, parallel/mesh.py).

One process a card by default: ``init_ranks`` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or takes the rank, the world size and an explicit
``init_method`` (``file://...``, ``tcp://...``), and calls
``init_process_group`` with a timeout. Nothing is guessed:

  * the backend is named: "nccl" (the default of a CUDA rank) or "gloo"
    (CPU ranks, and CUDA ranks that share one card: NCCL refuses two
    ranks of one communicator on one GPU);
  * the device is named: ``cuda:LOCAL_RANK`` by default, or the one the
    caller gives; a rank without CUDA raises unless the CPU was asked
    for, and NCCL without CUDA raises.

The transport of parallel/halo.py runs on two calls here: ``exchange``,
one ``batch_isend_irecv`` of point-to-point pieces, and ``all_gather``,
every rank's stacked partials in rank order. A gloo rank stages a CUDA
tensor through pinned host memory: a call's sends are copied out
without a wait and waited for once, and what it receives is copied in
without a wait. A failed send or a timeout raises on the rank that
waits; no rank carries on alone. ``stats`` counts this process's
messages and bytes: the point-to-point ones, and the all-gathers with the
bytes this rank put in and the bytes it received from the other ranks
(world - 1 times what each rank puts in). The sums of parallel/halo.py
are such all-gathers of every shard's field-sized partial, so on a
process mesh they, not the halo sends, carry most of a step's bytes.
"""

from __future__ import annotations

import datetime
import gc
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# this process's transport since the last reset_stats(): point-to-point
# messages sent and received and their bytes, all-gathers, the bytes this
# rank contributed to them and the bytes it received from the others
stats: Dict[str, int] = {}


def reset_stats() -> None:
    for k in ("sent", "sent_bytes", "received", "received_bytes",
              "all_gather", "all_gather_bytes", "all_gather_received_bytes"):
        stats[k] = 0


reset_stats()


class Ranks(NamedTuple):
    """A process of the group: its rank, the world size, its device and
    the group's backend."""
    group: object
    rank: int
    world: int
    device: torch.device
    backend: str


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"init_ranks: {name} is neither given nor set "
                           "(run under torchrun, or set RANK, WORLD_SIZE "
                           "and LOCAL_RANK)")
    return int(os.environ[name])


def init_ranks(backend: Optional[str] = None, device=None, *,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout: float = 120.0) -> Ranks:
    """Join the process group and pick this rank's device (module
    docstring). ``backend``: "nccl" or "gloo" (None: "nccl", for a CUDA
    rank only). ``device``: None for ``cuda:LOCAL_RANK``, else the
    device (``"cpu"`` for a CPU rank). ``init_method``: None for
    ``env://`` (``MASTER_ADDR`` and ``MASTER_PORT`` must be set).
    ``timeout``: seconds any collective or receive may wait before it
    raises."""
    rank = _env_int("RANK", rank)
    world = _env_int("WORLD_SIZE", world_size)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_ranks: CUDA is not available on this rank; pass "
                "device='cpu' (with backend='gloo') to run on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"init_ranks: {device} asked for, but CUDA is "
                           "not available on this rank")
    if backend is None:
        if device.type != "cuda":
            raise ValueError("init_ranks: name the backend of a CPU rank "
                             "(backend='gloo')")
        backend = "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"init_ranks: backend {backend!r} is not one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"init_ranks: NCCL needs a CUDA device, not "
                         f"{device}")
    if init_method is None:
        for name in ("MASTER_ADDR", "MASTER_PORT"):
            if name not in os.environ:
                raise RuntimeError(f"init_ranks: {name} is not set and no "
                                   "init_method was given")
        init_method = "env://"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout)))
    group = dist.group.WORLD
    # a first collective, so that no point-to-point call opens the group
    all_gather(group, torch.zeros(1, device=device))
    reset_stats()
    return Ranks(group, rank, world, device, backend)


def shutdown(ranks: Ranks) -> None:
    """Leave the process group, once every rank has come here (every
    rank calls it): no rank tears its connections down while another
    still uses them."""
    if dist.is_initialized():
        all_gather(ranks.group, torch.zeros(1, device=ranks.device))
        gc.collect()
        dist.destroy_process_group()
        gc.collect()


def _staged(group) -> bool:
    """Whether the group's transport takes host tensors only (gloo)."""
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the transport carries it: bfloat16 as its bits
    (int16), bool as bytes, so that every backend moves it bit for
    bit."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t


def _staged_out(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of the tensors for a transport that takes host tensors
    alone: each card's in a pinned buffer, copied without a wait, then
    one wait a card for all of them (host tensors as they are)."""
    out, cards = [], set()
    for t in tensors:
        if t.device.type == "cpu":
            out.append(t)
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        out.append(buf)
        cards.add(t.device)
    for d in cards:
        torch.cuda.current_stream(d).synchronize()
    return out


def _buffer(shape, dtype, device: torch.device, staged: bool
            ) -> torch.Tensor:
    """A receive buffer: on ``device``, or with ``staged`` on the host
    (pinned where a card takes it next)."""
    if staged and device.type != "cpu":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if staged else device)


def exchange(group, sends: Sequence[Tuple[int, torch.Tensor, int]],
             recvs: Sequence[Tuple[int, tuple, torch.dtype, torch.device,
                                   int]]) -> Dict[int, torch.Tensor]:
    """One batch of point-to-point moves: ``sends`` [(tag, tensor, peer)]
    and ``recvs`` [(tag, shape, dtype, device, peer)], posted in list
    order (each pair of ranks lists its pieces in the same order, and
    the tag names a piece within the batch). Waits for all of them;
    returns {tag: received tensor on its device}."""
    staged = _staged(group)
    ops = []
    wires = [_wire(t.contiguous()) for _, t, _ in sends]
    keep = _staged_out(wires) if staged else wires
    for (tag, _, peer), w in zip(sends, keep):
        ops.append(dist.P2POp(dist.isend, w, peer, group, tag))
        stats["sent"] += 1
        stats["sent_bytes"] += w.numel() * w.element_size()
    bufs = []
    for tag, shape, dtype, device, peer in recvs:
        wdt = _wire(torch.empty(0, dtype=dtype)).dtype
        buf = _buffer(shape, wdt, device, staged)
        bufs.append((tag, buf, dtype, device))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
        stats["received"] += 1
        stats["received_bytes"] += buf.numel() * buf.element_size()
    if not ops:
        return {}
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = {}
    for tag, buf, dtype, device in bufs:
        t = buf.to(device, non_blocking=True) if buf.device != device \
            else buf
        out[tag] = t.view(dtype) if t.dtype != dtype else t
    return out


def all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) stacked in rank order, on
    ``t``'s device: (world, *t.shape)."""
    world = dist.get_world_size(group)
    staged = _staged(group)
    w = _wire(t.contiguous())
    if staged:
        w = _staged_out([w])[0]
    parts = [_buffer(w.shape, w.dtype, t.device, staged)
             for _ in range(world)]
    dist.all_gather(parts, w, group=group)
    stats["all_gather"] += 1
    stats["all_gather_bytes"] += w.numel() * w.element_size()
    stats["all_gather_received_bytes"] += \
        (world - 1) * w.numel() * w.element_size()
    out = torch.empty((world,) + tuple(w.shape), dtype=w.dtype,
                      device=t.device)
    for i, p in enumerate(parts):
        out[i].copy_(p, non_blocking=True)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def gather_objects(group, obj) -> List[object]:
    """Every rank's picklable ``obj`` in rank order (set-up only)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
