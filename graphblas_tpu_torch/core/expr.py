"""``c(mask=, accum=, replace=)`` as an Updater: ``<<`` an expression into
it, or assign a scalar with ``[:] = s`` (graphblas_tpu/core/expr.py)."""

from . import execute


class Updater:
    def __init__(self, parent, *, mask=None, accum=None, replace=False,
                 opts=None):
        if replace and mask is None:
            raise ValueError("replace=True requires a mask")
        self.parent = parent
        self.mask = mask
        self.accum = accum
        self.replace = replace
        self.opts = opts

    def __lshift__(self, expr):
        return self.update(expr)

    def update(self, expr):
        execute.update_into(self.parent, execute.as_expr(expr),
                            mask=self.mask, accum=self.accum,
                            replace=self.replace, opts=self.opts)

    def __setitem__(self, keys, value):
        if not (isinstance(keys, slice) and keys == slice(None)):
            raise NotImplementedError(
                "only whole-vector assignment `v(...)[:] = s` is in the "
                "PyTorch port yet (ROADMAP.md queue 1, item 10)")
        execute.assign_scalar(self.parent, value, mask=self.mask,
                              accum=self.accum, replace=self.replace)
