"""Aggregators: reductions beyond monoids (graphblas_tpu/core/operator/
agg.py).  Each is a declarative spec of three stages, which the dense
engine's ``reduce_agg`` runs over the stored elements: map the values,
reduce them with a monoid, finalize the result with the count of stored
elements.  The map and finalize functions are torch functions here.

The 37 builtins: sum, prod, all, any, min, max, any_value, bitwise_all,
bitwise_any; count, count_nonzero, count_zero, sum_of_squares,
sum_of_inverses, exists; hypot, logaddexp, logaddexp2; L0norm, L1norm,
L2norm, Linfnorm; mean, peak_to_peak, varp, vars, stdp, stds,
geometric_mean, harmonic_mean, root_mean_square; and under ``agg.ss``
argmin, argmax, first, last, first_index, last_index.  ``Aggregator(name,
monoid=..., semiring=..., ...)`` builds a user aggregator from operators,
as in the JAX package.
"""

import inspect

import torch

from .. import dtypes as _dt
from .base import OpBase, TypedOpBase, typed

__all__ = ["Aggregator", "TypedAggregator"]


def _float_ret(dt):
    return dt if dt.is_float else _dt.FP64


class AggSpec:
    """map(values) -> mapped; monoid-reduce; finalize(acc, count) -> result.

    monoid_name is a builtin monoid's name or a Monoid (user aggregators),
    or one of the engine's own: "minmax" (peak_to_peak), "var_p",
    "var_s", "std_p", "std_s".  composite, when set, is a list of child
    specs evaluated on the same input; finalize_fn then receives the child
    results in order, followed by the count.  custom(vals, valid, axis)
    computes the whole reduce.  index_kind: None, "argmin", "argmax",
    "first", "last", "first_index" or "last_index"."""

    __slots__ = ("name", "map_fn", "monoid_name", "finalize_fn", "ret_rule",
                 "index_kind", "types_domain", "composite", "custom")

    def __init__(self, name, map_fn, monoid_name, finalize_fn=None, *,
                 ret_rule=None, index_kind=None, types_domain="all",
                 composite=None, custom=None):
        self.name = name
        self.map_fn = map_fn
        self.monoid_name = monoid_name
        self.finalize_fn = finalize_fn
        self.ret_rule = ret_rule
        self.index_kind = index_kind
        self.types_domain = types_domain
        self.composite = composite
        self.custom = custom


def _ident(x):
    return x


def _is_bool(x):
    return x.dtype == torch.bool


def _to_f(x):
    return x if x.dtype.is_floating_point else x.to(torch.float64)


def _truth(x):
    return x if _is_bool(x) else x != 0


def _ones(x):
    return torch.ones(x.shape, dtype=torch.int64, device=x.device)


_SPECS = {}


def _spec(*args, **kwargs):
    s = AggSpec(*args, **kwargs)
    _SPECS[s.name] = s
    return s


# monoids alone
_spec("sum", _ident, "plus")
_spec("prod", _ident, "times")
_spec("all", _truth, "land", ret_rule=_dt.BOOL)
_spec("any", _truth, "lor", ret_rule=_dt.BOOL)
_spec("min", _ident, "min")
_spec("max", _ident, "max")
_spec("any_value", _ident, "any")
_spec("bitwise_all", _ident, "band", types_domain="uint")
_spec("bitwise_any", _ident, "bor", types_domain="uint")

# counts and sums of a mapped value
_spec("count", _ones, "plus", ret_rule=_dt.INT64)
_spec("count_nonzero", lambda x: (x != 0).to(torch.int64), "plus",
      ret_rule=_dt.INT64)
_spec("count_zero", lambda x: (x == 0).to(torch.int64), "plus",
      ret_rule=_dt.INT64)
_spec("sum_of_squares", lambda x: x * x, "plus",
      ret_rule=lambda dt: dt if dt.is_float else _dt.INT64)
_spec("sum_of_inverses", lambda x: 1.0 / _to_f(x), "plus",
      ret_rule=_float_ret)
_spec("exists", _ones, "any", ret_rule=_dt.INT64)
_spec("hypot", lambda x: _to_f(x) ** 2, "plus",
      lambda acc, cnt: torch.sqrt(acc), ret_rule=_float_ret)
_spec("logaddexp", lambda x: torch.exp(_to_f(x)), "plus",
      lambda acc, cnt: torch.log(acc), ret_rule=_float_ret)
_spec("logaddexp2", lambda x: torch.exp2(_to_f(x)), "plus",
      lambda acc, cnt: torch.log2(acc), ret_rule=_float_ret)
_spec("L0norm", lambda x: (x != 0).to(torch.int64), "plus",
      ret_rule=_dt.INT64)
_spec("L1norm", lambda x: x.to(torch.int64) if _is_bool(x) else x.abs(),
      "plus", ret_rule=lambda dt: _dt.INT64 if dt.is_bool else dt)
_spec("L2norm", lambda x: _to_f(x.abs() if not _is_bool(x) else x) ** 2,
      "plus", lambda acc, cnt: torch.sqrt(acc), ret_rule=_float_ret)
_spec("Linfnorm", lambda x: _to_f(x).abs(), "max", ret_rule=_float_ret)

# a finalize with the count
_spec("mean", _to_f, "plus", lambda acc, cnt: acc / cnt, ret_rule=_float_ret)
_spec("peak_to_peak", _ident, "minmax")  # the engine takes max - min
_spec("varp", _to_f, "var_p", ret_rule=_float_ret)
_spec("vars", _to_f, "var_s", ret_rule=_float_ret)
_spec("stdp", _to_f, "std_p", ret_rule=_float_ret)
_spec("stds", _to_f, "std_s", ret_rule=_float_ret)
_spec("geometric_mean", lambda x: torch.log(_to_f(x)), "plus",
      lambda acc, cnt: torch.exp(acc / cnt), ret_rule=_float_ret)
_spec("harmonic_mean", lambda x: 1.0 / _to_f(x), "plus",
      lambda acc, cnt: cnt / acc, ret_rule=_float_ret)
_spec("root_mean_square", lambda x: _to_f(x) ** 2, "plus",
      lambda acc, cnt: torch.sqrt(acc / cnt), ret_rule=_float_ret)

# positions of the stored elements (agg.ss)
_spec("argmin", _ident, "min", ret_rule=_dt.INT64, index_kind="argmin")
_spec("argmax", _ident, "max", ret_rule=_dt.INT64, index_kind="argmax")
_spec("first", _ident, "any", index_kind="first")
_spec("last", _ident, "any", index_kind="last")
_spec("first_index", _ident, "min", ret_rule=_dt.INT64,
      index_kind="first_index")
_spec("last_index", _ident, "max", ret_rule=_dt.INT64,
      index_kind="last_index")

SS_ONLY = frozenset(["argmin", "argmax", "first", "last", "first_index",
                     "last_index"])


def _opclass(op):
    return getattr(op, "opclass", None)


def _n_params(fn):
    try:
        return len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _spec_from_parts(name, *, initval=None, monoid=None, semiring=None,
                     switch=False, semiring2=None, applybegin=None,
                     finalize=None, composite=None, custom=None, types=None,
                     any_dtype=None):
    """An AggSpec from the declarative parts of the JAX package's
    Aggregator constructor (see Aggregator).  ``semiring2`` and ``types``
    are accepted and not used, as there."""
    if custom is not None:
        return AggSpec(name, _ident, "plus", custom=custom)
    ret_rule = None if any_dtype is True or any_dtype is None else \
        _dt.lookup_dtype(any_dtype)

    def unary_fn(op):
        if _opclass(op) == "UnaryOp":
            def fn(x):
                return typed(op, _dt.lookup_dtype(x.dtype), "UnaryOp")(x)

            fn.op = op
            return fn
        if callable(op):
            return op
        raise TypeError(f"expected a UnaryOp or callable; got {op!r}")

    if composite is not None:
        children = []
        for child in composite:
            if not isinstance(child, (Aggregator, TypedAggregator)):
                raise TypeError(f"composite children must be Aggregators; "
                                f"got {child!r}")
            children.append(child.spec)
        if finalize is None:
            raise TypeError("composite aggregators require finalize")
        fin = finalize
        if _n_params(fin) == len(children):
            def fin_fn(*args):  # drop the count
                return fin(*args[:-1])
        else:
            fin_fn = fin
        return AggSpec(name, _ident, "plus", fin_fn, ret_rule=ret_rule,
                       composite=children)

    pre = None if applybegin is None else unary_fn(applybegin)
    if monoid is not None:
        if _opclass(monoid) == "Semiring":
            monoid = monoid.monoid
        if _opclass(monoid) != "Monoid":
            raise TypeError(f"monoid= must be a Monoid; got {monoid!r}")
        if isinstance(monoid, TypedOpBase):
            monoid = monoid.parent
        return AggSpec(name, pre if pre is not None else _ident, monoid,
                       ret_rule=ret_rule)
    if semiring is None:
        raise TypeError("Aggregator requires one of monoid=, semiring=, "
                        "composite=, custom=")
    if _opclass(semiring) != "Semiring":
        raise TypeError(f"semiring= must be a Semiring; got {semiring!r}")
    if isinstance(semiring, TypedOpBase):
        semiring = semiring.parent
    mult, mono = semiring.binaryop, semiring.monoid
    init = False if initval is None else initval
    init_dt = _dt.lookup_dtype(type(init)) if not hasattr(init, "dtype") \
        else _dt.lookup_dtype(init.dtype)

    def mult_for(d):
        from ..collection import unify

        return typed(mult, unify(init_dt, d) if switch else unify(d, init_dt),
                     "BinaryOp")

    def map_fn(x):
        y = pre(x) if pre is not None else x
        op = mult_for(_dt.lookup_dtype(y.dtype))
        iv = _dt.to_tensor(init, op.type, y.device).expand(y.shape)
        yv = _dt.normalize(y, op.type)
        return op(iv, yv) if switch else op(yv, iv)

    fin_fn = None
    if finalize is not None:
        fu = unary_fn(finalize)
        # a builtin (torch.log2) has no signature to read: it takes the
        # result alone
        if hasattr(fu, "op") or _n_params(finalize) in (None, 1):
            def fin_fn(acc, cnt):
                return fu(acc)
        else:
            fin_fn = fu

    if ret_rule is None:
        def ret_rule(dt):  # through the chain of operators
            try:
                d = dt
                if pre is not None and hasattr(pre, "op"):
                    d = typed(pre.op, d, "UnaryOp").return_type
                d = mult_for(d).return_type
                d = mono[d].return_type
                if fin_fn is not None and hasattr(fu, "op"):
                    d = typed(finalize, d, "UnaryOp").return_type
                return d
            except (KeyError, TypeError):
                return dt

    return AggSpec(name, map_fn, mono, fin_fn, ret_rule=ret_rule)


_ALL = (_dt.BOOL, _dt.INT32, _dt.INT64, _dt.UINT32, _dt.FP32, _dt.FP64)


class TypedAggregator(TypedOpBase):
    opclass = "Aggregator"

    def __init__(self, parent, type_):
        rr = parent.spec.ret_rule
        ret = type_ if rr is None else (rr(type_) if callable(rr) else rr)
        super().__init__(parent, parent.name, type_, ret)
        self.spec = parent.spec

    def __repr__(self):
        return f"agg.{self.name}[{self.type.name}]"

    def __call__(self, val):
        return self.parent(val)


class Aggregator(OpBase):
    """An aggregator: a reduction beyond plain monoids.

    ``Aggregator(name, spec)`` wraps a prebuilt AggSpec.  The JAX
    package's declarative form, ``Aggregator(name, monoid=...,
    semiring=..., initval=..., switch=..., semiring2=..., applybegin=...,
    finalize=..., composite=..., types=..., any_dtype=...)``, builds one:

    * ``monoid``: reduce with that monoid (or a semiring's monoid);
    * ``semiring`` with ``initval`` (default False) and ``switch``: each
      stored x maps to ``mult(x, initval)`` (``mult(initval, x)`` with
      switch), reduced with the semiring's monoid;
    * ``applybegin``: a UnaryOp (or a torch function) applied first;
    * ``finalize``: a UnaryOp, or a torch function ``f(acc)`` or
      ``f(acc, count)``, applied to the result;
    * ``composite=[aggregators]``: each child on the same input, then
      ``finalize(*child_results[, count])``;
    * ``custom``: a torch function ``f(vals, valid, axis)`` that computes
      the whole reduce (axis None: over all);
    * ``any_dtype``: a DataType that fixes the return type.
    """

    opclass = "Aggregator"

    def __init__(self, name, spec=None, **parts):
        super().__init__(name)
        if spec is None:
            spec = _spec_from_parts(name, **parts)
        elif parts:
            raise TypeError("cannot pass both a spec and declarative parts")
        self.spec = spec

    def __repr__(self):
        return f"agg.{self.name}"

    @property
    def types(self):
        """Input type -> return type, over the types it takes."""
        spec = self.spec
        if spec.types_domain == "uint":
            domain = (_dt.UINT32,)
        elif isinstance(spec.monoid_name, OpBase):
            mono = spec.monoid_name
            domain = tuple(dt for dt in _ALL if dt in mono._domains) or _ALL
        else:
            domain = _ALL
        return {dt: TypedAggregator(self, dt).return_type for dt in domain}

    def _build_typed(self, dt):
        if dt not in self.types:
            return None
        return TypedAggregator(self, dt)

    def __contains__(self, dtype):
        try:
            self[dtype]
        except (KeyError, NotImplementedError):
            return False
        return True

    def __call__(self, val):
        """``agg.sum(v)``: the reduce of a Vector, or of all of a Matrix."""
        from ..base import BaseType

        if isinstance(val, BaseType) and val.ndim == 1:
            return val.reduce(self)
        if getattr(val, "ndim", None) == 2:
            return val.reduce_scalar(self)
        raise TypeError(f"Bad type when calling {self!r}: expected a "
                        f"Vector or Matrix; got {type(val).__name__}")


def initialize_builtins():
    """({name: Aggregator} of gb.agg, {name: Aggregator} of gb.agg.ss)."""
    ops, ss_ops = {}, {}
    for name, spec in _SPECS.items():
        (ss_ops if name in SS_ONLY else ops)[name] = Aggregator(name, spec)
    return ops, ss_ops
