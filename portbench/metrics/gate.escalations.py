"""Chunks the gate redid with full CG in the window and the traced
window (BoussinesqModel.escalations, after minus before)."""


def read(run):
    return run.escalations
