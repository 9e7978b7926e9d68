"""Per-call descriptor options (graphblas_tpu/core/opts.py).

Every operation takes ``**opts``.  On the card they are hints:
``nthreads`` and ``chunk`` are validated and do nothing (the CUDA kernels
choose their own launch shapes), ``axb_method`` chooses an mxm
formulation (``dot`` or ``gustavson``; the others choose as ``default``
does, by the smaller expansion), and ``sort``, ``secure_import``,
``compression`` and ``compression_level`` are accepted for the import,
export and serialize paths.  An unknown option or a bad value raises
ValueError, as in the JAX package."""

__all__ = ["validate_opts"]

_AXB_METHODS = {"gustavson", "dot", "hash", "saxpy", "default"}
_COMPRESSIONS = {"none", "default", "lz4", "lz4hc", "zstd"}
_VALID = {"nthreads", "chunk", "axb_method", "sort", "secure_import",
          "compression", "compression_level"}


def _one_of(key, val, choices):
    if not isinstance(val, str) or val.lower() not in choices:
        raise ValueError(
            f"Invalid value for {key!r} descriptor option: {val!r}. Must be "
            f"one of {', '.join(repr(x) for x in sorted(choices))}")


def validate_opts(opts):
    """Check per-call descriptor options; returns them (a dict)."""
    if not opts:
        return {}
    for key, val in opts.items():
        if key not in _VALID:
            raise ValueError(
                f"Descriptor option {key!r} not understood with cuda "
                f"backend. Valid options: {', '.join(sorted(_VALID))}")
        if val is None or val is False:
            continue
        if key == "axb_method":
            _one_of(key, val, _AXB_METHODS)
        elif key == "compression":
            _one_of(key, val, _COMPRESSIONS)
        elif key in ("nthreads", "compression_level", "chunk"):
            if not isinstance(val, (int, float)):
                raise ValueError(f"Invalid value for {key!r} descriptor "
                                 f"option: {val!r}")
        elif not isinstance(val, (bool, int)):  # sort, secure_import
            raise ValueError(f"Invalid value for {key!r} descriptor option: "
                             f"{val!r}")
    return opts
