"""Masks: ``v.S``, ``v.V`` and their complements ``~v.S``, ``~v.V``, of a
Vector or a Matrix (graphblas_tpu/core/mask.py), with ``m.new()`` and the
mask algebra ``m1 & m2``, ``m1 | m2``.

A mask whose parent is sparse-backed is evaluated at the coordinates a
sparse result writes (``execute._coord_mask_fn``); only a dense-backed
target needs its plane, which is made under the ``dense_limit`` guard and
leaves the parent sparse.

Combining two masks keeps that property.  Each mask is a set P of
positions (a parent's structure, or its nonzero values) or the complement
of one, so every pair combines into a set or a complemented set:
``a & ~b`` is P_a minus P_b, ``~a | ~b`` is the complement of the
intersection.  Over two sparse parents the sets are merged as sorted
coordinates on their device; otherwise over the dense planes.  The result
is a StructuralMask, or a ComplementedStructuralMask, over a BOOL
collection of True values at P.  The JAX package densifies both operands
and always returns a StructuralMask: the positions a mask lets through
are the same, the class may differ."""

import torch

from ..exceptions import DimensionMismatch
from .engine import dense


class Mask:
    complement = False
    structure = False
    value = False

    def __init__(self, parent):
        self.parent = parent

    def __invert__(self):
        return _FLIP[type(self)](self.parent)

    def __eq__(self, other):
        raise TypeError(f"__eq__ not defined for objects of type "
                        f"{type(self)}.")

    __hash__ = object.__hash__

    def __bool__(self):
        raise TypeError(f"__bool__ not defined for objects of type "
                        f"{type(self)}.")

    def __repr__(self):
        from .formatting import format_mask

        return format_mask(self)

    def _repr_html_(self):
        from .formatting import format_mask

        return f"<pre>{format_mask(self)}</pre>"

    @property
    def name(self):
        return repr(self)

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def shape(self):
        return self.parent.shape

    @property
    def ndim(self):
        return self.parent.ndim

    def _as_array(self):
        """The dense write-permission plane."""
        p = self.parent
        vals, valid = (p._dense_planes() if p._sparse is not None
                       else (p._vals, p._valid))
        return dense.mask_array(vals, valid, p.dtype, self.structure,
                                self.complement)

    def new(self, dtype=None, *, complement=False, mask=None, name=None,
            **opts):
        """The positions this mask lets through (and mask's, if given), as
        a collection of True values of dtype (BOOL by default); with
        complement, the other positions."""
        from .dtypes import BOOL, lookup_dtype

        dt = BOOL if dtype is None else lookup_dtype(dtype)
        m = self
        if mask is not None:
            if not isinstance(mask, Mask):
                raise TypeError("mask argument must be a Mask")
            m = _combine(self, mask, "and")
        if complement:
            m = ~m
        positions, comp = _positive(m)
        if comp:  # the complement of a set: the other positions, as a plane
            positions = _complemented(positions, m.parent)
        return _true_at(positions, m.parent, dt, name)

    def __and__(self, other):
        return _combine(self, other, "and")

    def __rand__(self, other):
        return _combine(other, self, "and")

    def __or__(self, other):
        return _combine(self, other, "or")

    def __ror__(self, other):
        return _combine(other, self, "or")


class StructuralMask(Mask):
    structure = True


class ValueMask(Mask):
    value = True


class ComplementedStructuralMask(Mask):
    structure = True
    complement = True


class ComplementedValueMask(Mask):
    complement = True
    value = True


_FLIP = {StructuralMask: ComplementedStructuralMask,
         ComplementedStructuralMask: StructuralMask,
         ValueMask: ComplementedValueMask,
         ComplementedValueMask: ValueMask}


def _positive(mask):
    """(P, complemented): the set the mask names before its complement, as
    a SparseStore of its positions (sparse parent) or a bool plane."""
    p = mask.parent
    if p._sparse is not None:
        sp = p._sparse
        if not mask.structure:
            from .engine import sparse as spx

            keep = dense.truthy(sp.vals, p.dtype)
            sp = spx._filtered(sp, keep, keep, p.dtype)
        return sp, mask.complement
    return dense.mask_array(p._vals, p._valid, p.dtype, mask.structure,
                            False), mask.complement


def _as_plane(positions, parent):
    if isinstance(positions, torch.Tensor):
        return positions
    from .engine import sparse as spx

    return spx.densify(positions, parent.dtype, parent.device)[1]


def _complemented(positions, parent):
    """The positions a set leaves out, as a plane (dense_limit applies for
    a sparse parent, whose every other position is stored)."""
    if not isinstance(positions, torch.Tensor):
        from ..exceptions import OutOfMemory
        from . import config as _config

        limit = int(_config.config.get("dense_limit", 1 << 26))
        n = parent.shape[0] * (parent.shape[1] if parent.ndim == 2 else 1)
        if n > limit:
            raise OutOfMemory(f"a complemented mask of {n} positions is "
                              f"over dense_limit={limit}")
    return ~_as_plane(positions, parent)


def _true_at(positions, parent, dtype, name):
    """A collection shaped like parent with True (of dtype) at positions:
    sparse-backed for a sparse set, else dense."""
    if isinstance(positions, torch.Tensor):
        vals = torch.ones(positions.shape, dtype=dtype.torch_type,
                          device=positions.device)
        if parent.ndim == 1:
            from .vector import Vector

            return Vector._from_store(dtype, vals, positions.clone(),
                                      name=name)
        from .matrix import Matrix

        return Matrix._from_planes(dtype, vals, positions.clone(), name=name)
    from .engine import sparse as spx
    from .matrix import Matrix

    ones = torch.ones(positions.nvals(), dtype=dtype.torch_type,
                      device=positions.device)
    sp = spx.store_from_parts(positions.rows, positions.cols, ones,
                              positions.nrows, positions.ncols, dtype)
    return Matrix._from_sparse(dtype, sp, name=name)


# (how, left complemented, right complemented) -> (set operation of the
# positive sets, result complemented)
_ALGEBRA = {
    ("and", False, False): ("and", False),
    ("and", False, True): ("minus", False),
    ("and", True, False): ("rminus", False),
    ("and", True, True): ("or", True),
    ("or", False, False): ("or", False),
    ("or", False, True): ("rminus", True),
    ("or", True, False): ("minus", True),
    ("or", True, True): ("and", True),
}


def _combine(left, right, how):
    if not isinstance(left, Mask) or not isinstance(right, Mask):
        raise TypeError(f"Mask must be combined with another mask; got "
                        f"{type(left)} and {type(right)}")
    if tuple(left.parent.shape) != tuple(right.parent.shape):
        raise DimensionMismatch(f"Mask shapes do not match: "
                                f"{left.parent.shape} != "
                                f"{right.parent.shape}")
    pa, ca = _positive(left)
    pb, cb = _positive(right)
    setop, comp = _ALGEBRA[how, ca, cb]
    if setop == "rminus":
        setop, pa, pb = "minus", pb, pa
    if isinstance(pa, torch.Tensor) or isinstance(pb, torch.Tensor):
        a, b = _as_plane(pa, left.parent), _as_plane(pb, left.parent)
        positions = {"and": a & b, "or": a | b, "minus": a & ~b}[setop]
    else:
        positions = _sparse_setop(pa, pb, setop)
    from .dtypes import BOOL

    out = _true_at(positions, left.parent, BOOL, None)
    return (ComplementedStructuralMask if comp else StructuralMask)(out)


def _sparse_setop(a, b, setop):
    """Intersection, union or difference of two stores' coordinates,
    sorted, on their device."""
    from .engine import sparse as spx

    if setop == "or":
        rows, cols, _, _, _, _ = spx.merge_slots(a, b)
        return spx.store_from_parts(rows, cols, torch.ones_like(rows,
                                                                dtype=torch.bool),
                                    a.nrows, a.ncols, None)
    _, found = spx._find(b.struct.keys(), a.struct.keys())
    keep = found if setop == "and" else ~found
    return spx._filtered(a, keep, keep, None)
