"""Grid-point updates a second: cells x steps completed in the window
over the window's host seconds (a redone chunk counts its steps once and
all its time)."""


def read(run):
    return run.points * run.steps / run.window_s
