"""Value helpers over storage tensors (graphblas_tpu/core/engine/store.py):
``cast_values``, ``identity_value_array``, and the values of a
user-defined type (UDT).

The JAX package keeps a UDT's values as a pytree: a struct dtype is a
dict of field arrays and a subarray dtype a trailing dimension.  Here they
are a :class:`Tree`: one tensor a field (a subarray dtype's single array
under the key None), each shaped ``(*lead, *sub)``, where ``lead`` is the
shape of the values (a store's slots, a plane's rows and columns) and
``sub`` the field's subarray shape.  A Tree takes the tensor operations
the engines apply to values (indexing, ``torch.where``, ``torch.cat``,
``expand``, ``reshape``, ...) on its leading dimensions, field by field,
so a UDT moves through every engine that only moves values; what
computes on them is the user's function, which gets the fields as the
JAX package gives them (:meth:`Tree.user_view`)."""

import math

import numpy as np
import torch

from .. import dtypes as _dt


def _leaf_np_dtypes(dtype):
    """(field name or None, numpy dtype, subshape) of each leaf of a UDT."""
    nt = dtype.np_type
    if nt.names:
        for name in nt.names:
            ft = nt.fields[name][0]
            if ft.subdtype is not None:
                yield name, ft.subdtype[0], ft.subdtype[1]
            else:
                yield name, ft, ()
    elif nt.subdtype is not None:
        yield None, nt.subdtype[0], nt.subdtype[1]
    else:
        yield None, nt, ()


def _leaf_type(np_type):
    """The builtin DataType whose storage carries a leaf."""
    dt = _dt.lookup_dtype(np.dtype(np_type))
    if dt._is_udt:
        raise TypeError(f"a field of type {np_type} has no builtin type to "
                        f"carry it")
    return dt


def _lead_dim(d, ndim):
    return d + ndim if d < 0 else d


class Tree:
    """The values of a user-defined type (see the module's docstring)."""

    __slots__ = ("fields", "subs")

    def __init__(self, fields, subs):
        self.fields = dict(fields)
        self.subs = subs

    def _map(self, fn):
        return Tree({k: fn(v, self.subs[k]) for k, v in self.fields.items()},
                    self.subs)

    # -- what the engines read of values --------------------------------
    @property
    def shape(self):
        k, v = next(iter(self.fields.items()))
        return v.shape[:v.dim() - len(self.subs[k])]

    @property
    def ndim(self):
        return len(self.shape)

    def dim(self):
        return self.ndim

    def numel(self):
        return math.prod(self.shape)

    def __len__(self):
        return self.shape[0]

    @property
    def device(self):
        return next(iter(self.fields.values())).device

    def is_complex(self):
        return False

    def is_floating_point(self):
        return False

    def user_view(self):
        """What a user function gets: a dict of field tensors, or the one
        array of a subarray dtype."""
        if None in self.fields:
            return self.fields[None]
        return dict(self.fields)

    # -- indexing on the leading dimensions -----------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return self.fields[key]
        return self._map(lambda v, sub: v[key])

    def __setitem__(self, key, value):
        for k, v in self.fields.items():
            v[key] = value.fields[k] if isinstance(value, Tree) else value

    # -- shapes ---------------------------------------------------------
    @staticmethod
    def _shape_arg(shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                     torch.Size)):
            return tuple(shape[0])
        return tuple(shape)

    def reshape(self, *shape):
        shape = self._shape_arg(shape)
        return self._map(lambda v, sub: v.reshape(shape + tuple(sub)))

    view = reshape

    def expand(self, *shape):
        shape = self._shape_arg(shape)
        return self._map(lambda v, sub: v.expand(shape + tuple(sub)))

    def unsqueeze(self, dim):
        d = _lead_dim(dim, self.ndim + 1)
        return self._map(lambda v, sub: v.unsqueeze(d))

    def squeeze(self, dim):
        d = _lead_dim(dim, self.ndim)
        return self._map(lambda v, sub: v.squeeze(d))

    def transpose(self, d0, d1):
        n = self.ndim
        a, b = _lead_dim(d0, n), _lead_dim(d1, n)
        return self._map(lambda v, sub: v.transpose(a, b))

    def t(self):
        return self.transpose(0, 1) if self.ndim == 2 else self

    T = property(t)

    def movedim(self, src, dst):
        n = self.ndim
        a, b = _lead_dim(src, n), _lead_dim(dst, n)
        return self._map(lambda v, sub: v.movedim(a, b))

    # -- copies and devices ---------------------------------------------
    def clone(self):
        return self._map(lambda v, sub: v.clone())

    def contiguous(self):
        return self._map(lambda v, sub: v.contiguous())

    def to(self, *args, **kwargs):
        return self._map(lambda v, sub: v.to(*args, **kwargs))

    def copy_(self, other):
        for k, v in self.fields.items():
            v.copy_(other.fields[k])
        return self

    def new_zeros(self, shape):
        shape = tuple(shape)
        return self._map(lambda v, sub: v.new_zeros(shape + tuple(sub)))

    def __repr__(self):
        return f"Tree({self.fields!r})"

    # -- torch functions ------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        impl = _TREE_FUNCS.get(func)
        if impl is None:
            raise TypeError(f"{getattr(func, '__name__', func)} does not "
                            f"take the values of a user-defined type")
        return impl(*args, **kwargs)


def _tree_of(xs):
    return next(x for x in xs if isinstance(x, Tree))


def _field(x, k):
    return x.fields[k] if isinstance(x, Tree) else x


def _where(cond, x, y):
    t = _tree_of((x, y))
    out = {}
    for k, sub in t.subs.items():
        c = cond.reshape(cond.shape + (1,) * len(sub)) if isinstance(
            cond, torch.Tensor) else cond
        out[k] = torch.where(c, _field(x, k), _field(y, k))
    return Tree(out, t.subs)


def _cat(seq, dim=0):
    seq = list(seq)
    t = _tree_of(seq)
    d = _lead_dim(dim, t.ndim)
    return Tree({k: torch.cat([s.fields[k] for s in seq], d)
                 for k in t.subs}, t.subs)


def _like(fn):
    def impl(x, *args, **kwargs):
        return x._map(lambda v, sub: fn(v, *args, **kwargs))

    return impl


def _along(x, indices, dim):
    """take_along_dim over the leading dimensions: the index spans each
    field's subarray dimensions too."""
    d = _lead_dim(dim, x.ndim)

    def take(v, sub):
        idx = indices.reshape(indices.shape + (1,) * len(sub)).expand(
            indices.shape + tuple(sub))
        return torch.take_along_dim(v, idx, dim=d)

    return x._map(take)


def _gather(x, dim, index):
    return _along(x, index, dim)


def _take_along_dim(x, indices, dim=None):
    return _along(x, indices, dim)


def _diagonal(x, offset=0, dim1=0, dim2=1):
    # torch puts the diagonal last: move it before the subarray dimensions
    return x._map(lambda v, sub: torch.diagonal(v, offset, dim1, dim2)
                  .movedim(-1, 0))


def _pad(x, pad, mode="constant", value=None):
    """F.pad of the leading dimensions: a field's subarray dimensions,
    last in the tensor and first in pad's order, take no padding."""
    return x._map(lambda v, sub: torch.nn.functional.pad(
        v, (0, 0) * len(sub) + tuple(pad), mode, value))


_TREE_FUNCS = {
    torch.where: _where, torch.cat: _cat,
    torch.zeros_like: _like(torch.zeros_like),
    torch.empty_like: _like(torch.empty_like),
    torch.take_along_dim: _take_along_dim, torch.gather: _gather,
    torch.diagonal: _diagonal, torch.nn.functional.pad: _pad,
}


def zeros_values(shape, dtype, device):
    """A zero-filled values plane of shape in dtype's storage (a Tree of
    zero fields for a UDT)."""
    shape = tuple(shape)
    if not dtype._is_udt:
        return torch.zeros(shape, dtype=dtype.torch_type, device=device)
    fields, subs = {}, {}
    for name, nt, sub in _leaf_np_dtypes(dtype):
        fields[name] = torch.zeros(shape + tuple(sub),
                                   dtype=_leaf_type(nt).torch_type,
                                   device=device)
        subs[name] = tuple(sub)
    return Tree(fields, subs)


def full_values(shape, dtype, fill, device):
    """A plane of shape filled with fill: a UDT's fields each take fill
    (or fill[name] for a dict), as the JAX package's monoid identity
    does."""
    out = zeros_values(shape, dtype, device)
    if not dtype._is_udt:
        return out.fill_(_dt.storage_scalar(fill, dtype))
    for name, v in out.fields.items():
        f = fill[name] if isinstance(fill, dict) else fill
        if isinstance(f, np.void):
            f = f.item()
        v.copy_(torch.as_tensor(np.asarray(f), dtype=v.dtype).expand(
            v.shape))
    return out


def np_values_to_device(array, dtype, device):
    """A host numpy array of a UDT (a struct or subarray array, or what
    np.asarray makes of a list of tuples) as a Tree on device: each field
    copied contiguous and carried as its builtin type's storage."""
    nt = dtype.np_type
    leaves = list(_leaf_np_dtypes(dtype))
    arr = np.asarray(array)
    if nt.names and arr.dtype != nt:
        arr = np.asarray(array, dtype=nt) if arr.dtype.names is None \
            else arr.astype(nt)
    fields, subs = {}, {}
    for name, leaf, sub in leaves:
        part = arr[name] if name is not None else arr
        part = np.array(part, dtype=leaf, copy=True)
        if name is None and nt.subdtype is not None and part.ndim < len(sub):
            part = part.reshape(sub)
        fields[name] = _dt.to_tensor(part, _leaf_type(leaf), device)
        subs[name] = tuple(sub)
    return Tree(fields, subs)


def device_values_to_np(values, dtype):
    """A Tree back to a host numpy array of dtype.np_type (a subarray
    dtype gives the array with its trailing dimensions)."""
    nt = dtype.np_type
    if nt.names:
        out = np.empty(tuple(values.shape), nt)
        for name, leaf, _ in _leaf_np_dtypes(dtype):
            out[name] = _dt.to_numpy(values.fields[name], _leaf_type(leaf))
        return out
    (name, leaf, _), = _leaf_np_dtypes(dtype)
    return _dt.to_numpy(values.fields[name], _leaf_type(leaf))


def from_user(out, dtype, like):
    """A user function's result as values of dtype: a dict or an array
    becomes a Tree shaped like the operand `like` (a Tree)."""
    if isinstance(out, Tree):
        return out
    subs = like.subs
    if isinstance(out, dict):
        fields = {k: torch.as_tensor(v, device=like.device)
                  for k, v in out.items()}
    else:
        fields = {None: torch.as_tensor(out, device=like.device)}
    lead = tuple(like.shape)
    return Tree({k: v.expand(lead + tuple(subs[k])) if v.dim() < len(lead)
                 + len(subs[k]) else v for k, v in fields.items()}, subs)


def cast_values(values, from_dtype, to_dtype):
    """GraphBLAS typecast (core/dtypes.py normalize: integers wrap, floats
    saturate, UINT64 reads as unsigned, a complex value's real part goes
    to a real type).  A UDT casts only to itself."""
    if from_dtype == to_dtype:
        return values
    if from_dtype._is_udt or to_dtype._is_udt:
        if from_dtype.np_type == to_dtype.np_type:
            return values
        raise TypeError(f"Cannot cast UDT {from_dtype} to {to_dtype}")
    return _dt.normalize(values, to_dtype, from_dtype)


def identity_value_array(mono, dtype, device):
    """Monoid identity as a 0-d storage tensor of dtype (a 0-d Tree for a
    UDT; None for a monoid without one)."""
    ident = mono.identity
    if ident is None:
        return None
    if dtype._is_udt:
        return full_values((), dtype, ident, device)
    return torch.tensor(_dt.storage_scalar(ident, dtype),
                        dtype=dtype.torch_type, device=device)
