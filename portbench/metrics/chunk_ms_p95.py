"""The 95th percentile over every chunk of the window of the host time
from the chunk's multi_step call to the return of its gate read, redo
included (ms)."""

from core.stats import percentile


def read(run):
    return 1e3 * percentile(run.chunk_s, 95)
