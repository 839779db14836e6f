"""The staggered (mimetic) operators on a mesh: what the JAX package's
mimetic model runs through GSPMD's plain path, in plain PyTorch on the
shards (models/mimetic.py's mesh step).

Each shard runs the single-device operators (ops/staggered.py,
ops/stencil.py) on a window of the global grid around its block, and
keeps its own block of the result. The window holds the shard's rows and
columns and ``WIDTH`` more on each side of every sharded axis (gathered
from the shards that own them, ``halo.windows``, on a mesh that spans
processes from other ranks too; a periodic axis wraps:
the box's y and x, the annulus's phi, the slab's x, the shell's lon; a
one-axis mesh's window holds the whole vertical axis). On the shell the
lat extent stops at a pole, so that a window that holds a pole closes it
with the operators' own pole rule (the half-turn roll): for that, after
its own columns, the window holds the same number of columns at lon +
pi, the roll's partners. The operators' wall rules and wraps at the
window's other edges, and the zero hi-wall face the staggered ``expand``
appends there, touch only the ``WIDTH`` cells next to them, which the
crop drops: the chains the step applies between two gathers (the
vorticity, Sadourny cross product and kinetic energy of the tendency;
C^T M C; the flux-form transport) reach two cells. Every owned cell and
face then sees the values and metric of the single-device operators, so
the two agree to round-off. Faces are the model's cell-shaped left
faces: a shard owns the faces of its cells, and the shared face of two
shards is the owner's (``face_seams``' rule); the wall faces (the
vertical wall on every shard, the shell's pole lat face on the bottom
lat shard) are written by the shard that owns them
(``ShardedStep.wall_faces``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BCSpec
from dycoreplanet_tpu_torch.ops.staggered import StaggeredOps
from dycoreplanet_tpu_torch.parallel.halo import windows
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, build, local_shape, offsets, row_rule, window_geometry)

# the cells a window reaches past its shard's block
WIDTH = 3


class StagFields(NamedTuple):
    """The staggered operators of a grid or window and the face constants
    of the mimetic tendency there."""
    stag: StaggeredOps
    gravity_face0: torch.Tensor          # g at the axis-0 faces
    plan_vort0: Optional[torch.Tensor]   # the shell's planetary vorticity
    plan_vort1: Optional[torch.Tensor]


class _Window:
    """One shard's window: its geometry and operators, where its block
    lies in it, and its constants by dtype."""

    def __init__(self, model, rows, cols: np.ndarray, crop, device):
        self.rows, self.cols, self.crop = rows, cols, crop
        # the rows a host array is cut to (None: axis -2 whole, the
        # vertical axis of a one-axis mesh)
        self._rows = None if row_rule(model.geo) is None else np.asarray(rows)
        self.device = device
        self.geo = window_geometry(model.geo, rows, cols)
        self.stag = StaggeredOps(self.geo, model.u_specs, model.p_specs,
                                 dxi=model.stag.m.dxi)
        self._model = model
        self._by_dtype: Dict[torch.dtype, tuple] = {}

    def _cut(self, a: np.ndarray, lat_faces: bool = False) -> np.ndarray:
        """A global (..., n1 or nlat + 1, n2 or 1) host array (or a 2D
        grid's (n2,) wall values) cut to the window."""
        a = np.asarray(a)
        if self._rows is not None and a.ndim > 1:
            r = (np.arange(self.rows.start, self.rows.stop + 1)
                 if lat_faces else self._rows)
            a = a[..., r, :]
        if a.shape[-1] > 1:
            a = a[..., self.cols]
        return np.ascontiguousarray(a)

    def constants(self, dtype):
        """(StagFields, T_specs) of the window in ``dtype``."""
        out = self._by_dtype.get(dtype)
        if out is None:
            m = self._model
            t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                          device=self.device)
            pv = m._plan_vort_host
            fields = StagFields(
                self.stag, t(self._cut(m._gravity_face0_host)),
                None if pv is None else t(self._cut(pv[0], True)),
                None if pv is None else t(self._cut(pv[1])))
            r_spec = m.T_specs[0]
            T_specs = list(m.T_specs)
            if r_spec is not None:
                T_specs[0] = BCSpec(r_spec.lo, r_spec.hi,
                                    lo_value=t(self._cut(m.T_wall)))
            out = self._by_dtype[dtype] = (fields, T_specs)
        return out


class ShardedStaggered:
    """The windows of every shard of the geometry's mesh, and the mimetic
    step's operators on Sharded fields."""

    def __init__(self, model, mesh: Mesh, width: int = WIDTH):
        geo = model.geo
        n1, n2 = geo.cell_shape[-2:]
        nl, no = local_shape(geo, mesh)[-2:]
        B = mesh.grid[1]
        self.mesh = mesh
        self.scheme = model.advection_scheme
        # every shard's window (rows, cols): the pieces every process
        # lists alike; the operators of this process's windows alone
        self.specs, self.windows = {}, {}
        for (a, b), (j0, k0) in offsets(geo, mesh).items():
            own = np.arange(k0 - width, k0 + no + width) % n2
            cols, c0 = own, width
            if mesh.rows == "pole":
                rows = range(max(0, j0 - width), min(n1, j0 + nl + width))
                r0 = j0 - rows.start
                if B == 1:      # the whole ring: the pole roll as it is
                    cols, c0 = np.arange(n2), 0
                else:
                    cols = np.concatenate([own, (own + n2 // 2) % n2])
            elif mesh.rows == "periodic":
                rows = np.arange(j0 - width, j0 + nl + width) % n1
                r0 = width
            else:               # a one-axis mesh: the vertical axis whole
                rows, r0 = range(n1), 0
            self.specs[a, b] = (rows, cols)
            if mesh.is_local(a, b):
                crop = (slice(r0, r0 + nl), slice(c0, c0 + no))
                self.windows[a, b] = _Window(model, rows, cols, crop,
                                             mesh.device(a, b))
        self._memo = {}

    def memo(self, key, make: Callable):
        """``make()``, made once for ``key`` (the step's Sharded
        constants)."""
        out = self._memo.get(key)
        if out is None:
            out = self._memo[key] = make()
        return out

    def apply(self, fn: Callable, *fields) -> Sharded:
        """``fn(window, *the fields' windows)`` on every shard, cropped to
        the shard's block (each field's windows gathered in one transport
        call)."""
        got = [windows(f, self.mesh, self.specs) for f in fields]

        def one(a, b):
            w = self.windows[a, b]
            out = fn(w, *(g[a, b] for g in got))
            return out[..., w.crop[0], w.crop[1]].contiguous()

        return build(self.mesh, one)

    def curlcurl(self, x: Sharded) -> Sharded:
        """C^T M C of stacked cell-shaped faces (the momentum operator's
        viscous part, models/mimetic.py ``_solve_momentum_mimetic``)."""
        def cc(w, xw):
            sg = w.stag
            U = sg.expand(list(xw))
            return torch.stack(sg.contract(sg.curlcurl_weighted(U)))

        return self.apply(cc, x)

    def cell_velocity(self, faces) -> Sharded:
        """The cell-centred velocity of the faces (their averages)."""
        def avg(w, *fw):
            U = w.stag.expand(list(fw))
            return torch.stack([w.stag.avg_f2c(U[c], c)
                                for c in range(len(fw))])

        return self.apply(avg, *faces)

    def transport(self, u, u_faces, T: Sharded, dt_T) -> Sharded:
        """The conservative flux-form T - dt_T div(u T) with the faces
        ``u_faces`` (models/mimetic.py ``_advected_temperature``; ``u``
        unused)."""
        def one(w, *fw):
            *faces, Tw = fw
            _, T_specs = w.constants(Tw.dtype)
            return Tw - dt_T * st.advect_scalar(
                w.geo, faces, Tw, T_specs, scheme=self.scheme, form="flux")

        return self.apply(one, *u_faces, T)
