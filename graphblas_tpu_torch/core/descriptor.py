"""Descriptor (graphblas_tpu/core/descriptor.py): the flags replace,
mask_complement, mask_structure, transpose_first and transpose_second,
and per-call options.  The engine reads the flags directly, so a
Descriptor is a plain record; ``lookup`` caches the 32 of them."""

__all__ = ["Descriptor", "lookup"]

_FLAGS = ("replace", "mask_complement", "mask_structure", "transpose_first",
          "transpose_second")
_LETTERS = {"replace": "R", "mask_structure": "S", "mask_complement": "C",
            "transpose_first": "T0", "transpose_second": "T1"}


class Descriptor:
    __slots__ = (*_FLAGS, "opts", "name", "__weakref__")

    def __init__(self, *, replace=False, mask_complement=False,
                 mask_structure=False, transpose_first=False,
                 transpose_second=False, name=None, **opts):
        self.replace = replace
        self.mask_complement = mask_complement
        self.mask_structure = mask_structure
        self.transpose_first = transpose_first
        self.transpose_second = transpose_second
        self.opts = opts
        self.name = name or self._build_name()

    def _build_name(self):
        parts = "".join(_LETTERS[f] for f in ("replace", "mask_structure",
                                              "mask_complement",
                                              "transpose_first",
                                              "transpose_second")
                        if getattr(self, f))
        return "desc." + (parts or "NULL")

    def __repr__(self):
        return self.name


_cache = {}


def lookup(replace=False, mask_complement=False, mask_structure=False,
           transpose_first=False, transpose_second=False, **opts):
    flags = dict(replace=replace, mask_complement=mask_complement,
                 mask_structure=mask_structure,
                 transpose_first=transpose_first,
                 transpose_second=transpose_second)
    if opts:
        return Descriptor(**flags, **opts)
    key = tuple(flags.values())
    if key not in _cache:
        _cache[key] = Descriptor(**flags)
    return _cache[key]
