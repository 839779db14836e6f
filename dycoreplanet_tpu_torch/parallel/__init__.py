"""Multi-device runs of the shell step on a mesh of shards (one process)."""
