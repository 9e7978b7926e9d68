"""``graphblas_tpu_torch.ss``: extensions beyond the GraphBLAS C API
(graphblas_tpu/ss/__init__.py): ``diag``, ``concat``, the global
``config``, ``about``, ``burble``, the execution ``Context`` and
``iterate``."""

from ..core.ss.context import Context, global_context  # noqa: F401

__all__ = ["Context", "about", "burble", "concat", "config", "diag",
           "iterate"]


class GlobalConfig(dict):
    """The global config: the JAX package's keys, kept and read back
    (``burble`` is what ``burble()`` reports); an unknown key raises
    KeyError."""

    _defaults = {
        "format": "by_row",
        "hyper_switch": 0.0625,
        "bitmap_switch": [0.04, 0.05, 0.06, 0.08, 0.1, 0.2, 0.3, 0.4],
        "nthreads": 1,
        "chunk": 65536,
        "burble": False,
        "print_1based": False,
        "gpu_control": "always",
        "gpu_chunk": 0.0,
        "memory_pool": [],
    }

    def __init__(self):
        super().__init__(self._defaults)

    def __setitem__(self, key, value):
        if key not in self:
            raise KeyError(f"Unknown config key: {key}")
        super().__setitem__(key, value)


config = GlobalConfig()


class About(dict):
    """The port's facts: its name and version, torch's version, the CUDA
    version torch was built with and the devices it sees."""

    def __init__(self):
        import torch

        from .. import __version__

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        super().__init__({
            "library_name": "graphblas_tpu_torch",
            "library_version": tuple(int(x) for x in __version__.split(".")),
            "engine": "PyTorch + hand-written CUDA kernels",
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": "cuda" if n else "cpu",
            "devices": [torch.cuda.get_device_name(i) for i in range(n)]
            or ["cpu"],
            "openmp": False,
            "mode": "non-blocking",
        })


def __getattr__(name):
    if name == "about":  # read once, when first asked for
        globals()["about"] = About()
        return globals()["about"]
    raise AttributeError(
        f"module 'graphblas_tpu_torch.ss' has no attribute {name!r}")


def burble():
    return config["burble"]


def diag(x, k=0, dtype=None, *, name=None, **opts):
    """A Vector's diagonal Matrix, or a Matrix's k-th diagonal as a
    Vector."""
    from ..core.matrix import Matrix, TransposedMatrix
    from ..core.vector import Vector

    if isinstance(x, TransposedMatrix):
        x = x.new()
    if not isinstance(x, (Vector, Matrix)):
        raise TypeError(f"diag requires a Vector or Matrix; got {type(x)}")
    rv = x.diag(k, name=name)
    if dtype is not None:
        rv = rv.dup(dtype)
    return rv


def concat(tiles, dtype=None, *, name=None, **opts):
    """One collection from a list of Vectors, or a 2-D grid (a list of
    rows) of Matrices; the type unifies the tiles' unless dtype is given.
    Tiles that are all dense-backed join as planes, else as coordinates
    into a sparse-backed matrix."""
    import torch

    from ..core import dtypes as _dt
    from ..core.engine import sparse as spx
    from ..core.engine import store as st
    from ..core.matrix import Matrix, TransposedMatrix
    from ..core.vector import Vector

    if not isinstance(tiles, (list, tuple)) or not tiles:
        raise TypeError("tiles argument must be a non-empty list")
    if isinstance(tiles[0], Vector):
        dt = tiles[0].dtype
        for t in tiles[1:]:
            dt = _dt.unify(dt, t.dtype)
        if dtype is not None:
            dt = _dt.lookup_dtype(dtype)
        vals = torch.cat([st.cast_values(t._vals, t.dtype, dt)
                          for t in tiles])
        return Vector._from_store(dt, vals, torch.cat([t._valid
                                                       for t in tiles]),
                                  name=name)
    grid, dt = [], None
    for row in tiles:
        if not isinstance(row, (list, tuple)) or not row:
            raise TypeError("tiles must be a list of lists of Matrices")
        out_row = []
        for t in row:
            if isinstance(t, TransposedMatrix):
                t = t.new()
            if not isinstance(t, Matrix):
                raise TypeError(f"tiles must be Matrices; got {type(t)}")
            dt = t.dtype if dt is None else _dt.unify(dt, t.dtype)
            out_row.append(t)
        grid.append(out_row)
    if dtype is not None:
        dt = _dt.lookup_dtype(dtype)
    if all(t._sparse is None for row in grid for t in row):
        rows = [torch.cat([st.cast_values(t._d_vals, t.dtype, dt)
                           for t in row], dim=1) for row in grid]
        oks = [torch.cat([t._d_valid for t in row], dim=1) for row in grid]
        return Matrix._from_planes(dt, torch.cat(rows), torch.cat(oks),
                                   name=name)

    def store(t):
        sp = t._sparse if t._sparse is not None else \
            spx.from_dense(t._d_vals, t._d_valid, t.dtype)
        return sp.with_values(st.cast_values(sp.vals, t.dtype, dt), dt)

    return Matrix._from_sparse(dt, spx.concat_stores(
        [[store(t) for t in row] for row in grid], dt), name=name)


def iterate(body, state, *, cond=None, max_iter=64):
    """Run an algorithm loop (graphblas_tpu/ss/__init__.py ``iterate``).

    ``body(state, i)`` mutates the collections of ``state`` in place
    through normal GraphBLAS calls; ``i`` is a 1-based INT64 Scalar
    counter.  ``cond(state, i)``, evaluated after each body run, returns a
    Scalar; the loop continues while it is truthy (do-while), and always
    stops after ``max_iter`` runs.  Returns the number of runs.

    ``state`` maps names to Vectors and Matrices (anything else raises
    TypeError, as in the JAX package): the body replaces their stores
    through ``<<``.  The loop is plain Python and nothing is traced
    (the JAX package traces the body once, and its ``mxm`` planning has a
    branch for traced dense operands that needs no counterpart here);
    reading ``cond`` costs one device sync per iteration.  Replaying the
    body as a CUDA graph is ROADMAP.md queue 1, item 6.
    """
    from ..core.dtypes import INT64
    from ..core.matrix import Matrix
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    for name, v in state.items():
        if not isinstance(v, (Vector, Matrix)):
            raise TypeError(
                f"state[{name!r}] must be a Vector or Matrix; got {type(v)}")
    i = 0
    while i < max_iter:
        i += 1
        counter = Scalar.from_value(i, INT64)
        body(state, counter)
        if cond is not None:
            c = cond(state, counter)
            if c.is_empty or not c.value:
                break
    return i
