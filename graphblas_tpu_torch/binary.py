"""``graphblas_tpu_torch.binary``: the builtin binary operators of the port.
The positional ones (``firsti``, ``firstj``, ``secondi``, ``secondj``) live
under ``binary.ss``, as in the JAX package."""

import types

from .core.operator.binary import BUILTINS as _B, BinaryOp, TypedBinaryOp

_plain = {k: v for k, v in _B.items() if v._positional is None}
globals().update(_plain)
ss = types.SimpleNamespace(**{k: v for k, v in _B.items()
                              if v._positional is not None})

__all__ = ["BinaryOp", "TypedBinaryOp", "ss", *_plain]
