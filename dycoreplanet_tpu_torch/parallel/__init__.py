"""Multi-device runs of the step on a mesh of shards (one process, or one
process a card under ``torch.distributed``: parallel/dist.py)."""
