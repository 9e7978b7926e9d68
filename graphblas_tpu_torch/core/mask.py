"""Masks: ``v.S``, ``v.V`` and their complements ``~v.S``, ``~v.V``, of a
Vector or a Matrix (graphblas_tpu/core/mask.py).  A mask whose parent is
sparse-backed is evaluated at the coordinates a sparse result writes
(``execute._coord_mask_fn``); only a dense-backed target needs its plane,
which is made under the ``dense_limit`` guard and leaves the parent
sparse."""

from .engine import dense


class Mask:
    complement = False
    structure = False

    def __init__(self, parent):
        self.parent = parent

    def __invert__(self):
        return _FLIP[type(self)](self.parent)

    def __repr__(self):
        return f"{type(self).__name__}({self.parent!r})"

    def _as_array(self):
        """The dense write-permission plane."""
        p = self.parent
        vals, valid = (p._dense_planes() if p._sparse is not None
                       else (p._vals, p._valid))
        return dense.mask_array(vals, valid, p.dtype, self.structure,
                                self.complement)


class StructuralMask(Mask):
    structure = True


class ValueMask(Mask):
    pass


class ComplementedStructuralMask(Mask):
    structure = True
    complement = True


class ComplementedValueMask(Mask):
    complement = True


_FLIP = {StructuralMask: ComplementedStructuralMask,
         ComplementedStructuralMask: StructuralMask,
         ValueMask: ComplementedValueMask,
         ComplementedValueMask: ValueMask}
