from dycoreplanet_tpu_torch.grid.geometry import Geometry, Axis  # noqa: F401
from dycoreplanet_tpu_torch.grid.factory import (  # noqa: F401
    make_annulus,
    make_cuboid,
    make_geometry,
    make_shell,
    resolution_from_refinement,
)
