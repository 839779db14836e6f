"""Host calls that launch device work (kernels or graphs) in the traced
window, over its steps."""


def read(run):
    if run.traced is None:
        return None
    return run.traced.host_launches / run.traced_steps
