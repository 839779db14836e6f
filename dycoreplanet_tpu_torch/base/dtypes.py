"""The working dtypes (``dtype`` of the prm's Numerics section) and their
host side.

numpy has no bfloat16 of its own (the JAX package gets one from
``ml_dtypes``, which the port does not use). A bfloat16 model keeps its
host constants as float32 arrays whose values are rounded to bfloat16,
so that the device copy (``torch.as_tensor(a, dtype=torch.bfloat16)``)
is exact and holds the values the JAX package's bfloat16 arrays hold.
Rounding is to nearest, ties to even, through float32, as both torch's
and ml_dtypes' conversions from float64 do.
"""

from __future__ import annotations

import numpy as np
import torch

TORCH = {"float32": torch.float32, "float64": torch.float64,
         "bfloat16": torch.bfloat16}


def host_dtype(dtype: torch.dtype) -> type:
    """The numpy dtype that holds a working dtype's values on the host."""
    return np.float64 if dtype == torch.float64 else np.float32


def round_bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16 (nearest, ties to even; NaN stays NaN),
    as a float32 array: torch's float32 -> bfloat16 rounding."""
    f = np.asarray(a, dtype=np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(f), f, out)


def to_host(a, dtype: torch.dtype) -> np.ndarray:
    """``a`` as a host array of the working dtype ``dtype`` (values
    rounded to bfloat16 for a bfloat16 model)."""
    if dtype == torch.bfloat16:
        return round_bf16(a)
    return np.asarray(a, dtype=host_dtype(dtype))


def round_scalar(x, dtype: torch.dtype) -> float:
    """A Python float holding ``x`` rounded to ``dtype``."""
    if dtype == torch.bfloat16:
        return float(round_bf16(float(x)))
    return float(host_dtype(dtype)(x))


def eps(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).eps)


def is_bf16_array(a: np.ndarray) -> bool:
    """A numpy array of bfloat16 bits: ml_dtypes' bfloat16 (the JAX
    package's arrays) or the 2-byte void it reads back as without
    ml_dtypes (a ``.npz`` the JAX package wrote)."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's bits on the host as a ``'<V2'`` array, the
    bytes an ml_dtypes bfloat16 array holds (no arithmetic, no
    rounding)."""
    return t.detach().view(torch.int16).cpu().numpy().view("<V2")


def tensor_from_numpy(a, dtype: torch.dtype = None, device=None
                      ) -> torch.Tensor:
    """A copy of ``a`` on ``device``: a bfloat16 array
    (``is_bf16_array``) bit for bit, any other converted to ``dtype``
    (default: its own)."""
    a = np.array(a, order="C")
    if is_bf16_array(a):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 widened to float32
    (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
