"""``graphblas_tpu_torch.op``: the unary, binary, monoid and semiring
namespaces as one (graphblas_tpu/op/__init__.py): a name resolves in
unary, then binary, then monoid, then semiring."""


def from_string(string):
    """The operator a string names, of the first kind that parses it."""
    from ..core.operator import utils

    for kind in ("UnaryOp", "BinaryOp", "Monoid", "Semiring",
                 "IndexUnaryOp", "SelectOp", "Aggregator"):
        try:
            return utils.op_from_string(string, kind)
        except Exception:  # noqa: BLE001 - try the next kind, as there
            pass
    raise ValueError(f"Unknown op string: {string!r}.  Example usage: "
                     f"'abs[int]'")


def __dir__():
    from .. import binary, monoid, semiring, unary

    return sorted(set(globals()) | set(dir(unary)) | set(dir(binary))
                  | set(dir(monoid)) | set(dir(semiring)))


def __getattr__(key):
    if key.startswith("__"):
        raise AttributeError(key)
    from .. import binary, monoid, semiring, unary

    for mod in (unary, binary, monoid):
        try:
            rv = getattr(mod, key)
        except AttributeError:
            continue
        globals()[key] = rv
        return rv
    try:
        rv = getattr(semiring, key)
    except AttributeError:
        raise AttributeError(f"module 'graphblas_tpu_torch.op' has no "
                             f"attribute {key!r}") from None
    globals()[key] = rv
    return rv
