"""Process start to the first timed chunk (s): imports, the CUDA context,
the kernel libraries, the model's tables, the seeded state and the
chunk's graph captured and replayed."""


def read(run):
    return run.setup_s
