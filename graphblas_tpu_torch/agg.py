"""``graphblas_tpu_torch.agg``: the aggregators (graphblas_tpu/agg/).
``agg.count``, ``agg.mean``, ... reduce rows, columns, a whole matrix or a
vector (``A.reduce_rowwise(agg.mean)``, ``agg.sum(v)``).  The six that
depend on the order of the elements (argmin, argmax, first, last,
first_index, last_index) live under ``agg.ss``, as in the JAX package."""

from .core.operator.agg import Aggregator, TypedAggregator
from .core.operator.agg import SS_ONLY as _SS_ONLY
from .core.operator.agg import initialize_builtins as _init


class _SSNamespace:
    """``agg.ss``: the aggregators that depend on the elements' order."""

    def __init__(self, ops):
        self.__dict__.update(ops)


_ops, _ss_ops = _init()
globals().update(_ops)
ss = _SSNamespace(_ss_ops)


def from_string(string):
    """The aggregator a string names (``"count"``, ``"+"`` for sum,
    ``"ss.argmin"``, ``"mean[FP32]"``)."""
    from .core.operator.utils import aggregator_from_string

    return aggregator_from_string(string)


def __getattr__(name):
    if name in _SS_ONLY:
        raise AttributeError(
            f"gb.agg.{name} is available as gb.agg.ss.{name} "
            "(SuiteSparse-extension namespace, kept for API compatibility)")
    raise AttributeError(
        f"module 'graphblas_tpu_torch.agg' has no attribute {name!r}")


__all__ = ["Aggregator", "TypedAggregator", "from_string", "ss", *_ops]
