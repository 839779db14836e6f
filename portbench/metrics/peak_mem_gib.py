"""torch.cuda.max_memory_allocated over set-up and window (GiB), reset
at process start."""


def read(run):
    return run.peak_bytes / 2 ** 30
