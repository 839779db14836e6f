"""VTK output and checkpoints (counterpart of the JAX package's ``io/``)."""
from dycoreplanet_tpu_torch.io.vtk import write_vts, write_pvd  # noqa: F401
from dycoreplanet_tpu_torch.io.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint)
