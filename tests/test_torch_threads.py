"""The port's CPU tests run torch with one intra-op thread a process.

The tier-1 run puts six pytest-xdist workers on the machine's cores; with
its default, each worker's torch starts one intra-op thread a core, and
every parallel op then waits on threads that the other workers have
descheduled: the port's eager Krylov loops (thousands of small ops a
solve) ran an order of magnitude slower than one process alone, where
one thread a process costs them little. Every xdist worker imports every
test module while it collects, before any test runs, so this module's
setting holds for the whole session; its environment variable reaches
the CLI tests' subprocesses. One thread changes no result beyond the
order of a parallel reduction's partial sums over tensors of more than
torch's grain (32,768 values).
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
