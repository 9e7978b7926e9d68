"""Value helpers over storage tensors (graphblas_tpu/core/engine/store.py:
``cast_values`` and ``identity_value_array``).  Values are plain tensors,
the port has no struct types, so that module's ``zeros_values``,
``np_values_to_device`` and ``where_values`` are ``torch.zeros``,
``dtypes.to_tensor`` and ``torch.where`` here."""

import numpy as np
import torch

from .. import dtypes as _dt


def cast_values(values, from_dtype, to_dtype):
    """GraphBLAS typecast (C-cast semantics)."""
    if from_dtype == to_dtype:
        return values
    return _dt.normalize(values, to_dtype)


def identity_value_array(mono, dtype, device):
    """Monoid identity as a 0-d storage tensor of dtype (None for a monoid
    without one)."""
    ident = mono.identity
    if ident is None:
        return None
    if dtype is _dt.UINT32:
        return torch.tensor(int(ident) & 0xFFFFFFFF, dtype=torch.int64,
                            device=device)
    return torch.tensor(np.array(ident, dtype.np_type).item(),
                        dtype=dtype.torch_type, device=device)
