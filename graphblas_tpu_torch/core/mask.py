"""Masks: ``v.S``, ``v.V`` and their complements ``~v.S``, ``~v.V``, of a
Vector or a Matrix (graphblas_tpu/core/mask.py).  A mask of a sparse-backed
Matrix densifies it, under the ``dense_limit`` guard."""

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
        p = self.parent
        return dense.mask_array(p._vals, p._valid, p.dtype, self.structure,
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
