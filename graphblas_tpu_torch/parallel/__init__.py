"""Distribution: a matrix's rows cut into blocks over a mesh of devices
(graphblas_tpu/parallel/__init__.py).

As in the JAX package, one Python process drives every device of the
mesh, and user code stays ``shard_matrix(A, mesh); A.mxv(x).new()``.  A
:class:`Mesh` is an array of ``torch.device`` entries with named axes; a
device may appear several times (``make_mesh((8,),
devices=[torch.device("cpu")] * 8)`` is eight blocks on the CPU, four
``cuda:0`` entries four blocks on one card).

``shard_matrix`` gives a sparse-backed matrix row blocks (``A._dist``, a
:class:`BlockedCSR`, spmv.py).  Then mxv/vxm, the reduces, the masked
SpGEMM and extract run block by block, each block on its own device
through the port's single-device engine, with explicit copies and monoid
folds in place of the JAX package's collectives; ``select`` and unary
``apply`` keep the row blocks.  The sparse store stays authoritative for
everything else, and every write of a new store drops the blocks.

A dense-backed matrix or a vector is placed whole on the mesh's first
device: the port's dense engine computes on one tensor, so the result is
the same, by another route.  The JAX package's rule that a sharded
dimension divides evenly by its mesh axes is checked all the same, with
its exception (ValueError).
"""

import collections
import math

import numpy as np
import torch

from .spmv import (
    BlockedCSR,
    dist_bfs_step,
    dist_mxv,
    dist_mxv_ring,
    dist_pagerank_step,
    make_blocked_csr,
)

__all__ = [
    "make_mesh",
    "shard_matrix",
    "shard_vector",
    "replicate",
    "dist_mxv",
    "dist_mxv_ring",
    "BlockedCSR",
    "dist_bfs_step",
    "dist_pagerank_step",
    "make_blocked_csr",
    "Mesh",
    "P",
    "ewise_blocked",
]


class P(tuple):
    """A PartitionSpec: one entry a dimension, each a mesh axis name, a
    tuple of names or None (not sharded)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Devices in an array with named axes.  ``shape`` maps each axis
    name to its size, as JAX's ``Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        from ..core.engine.sortpipe import norm_device

        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} axes needs as many "
                             f"names; got {axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [norm_device(torch.device(d)) for d in arr.ravel()]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, arr.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        axes = ", ".join(f"{k!r}: {v}" for k, v in self.shape.items())
        return f"Mesh({axes})"


def _default_devices():
    """Every CUDA device, or the configured device where that is the CPU
    (or one named card); raises where no GPU is and the CPU was not asked
    for (config.device)."""
    from ..core import config as _config

    dev = _config.device()
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(shape=None, axis_names=None, *, devices=None):
    """Create a device mesh.  Default: 1D over every CUDA device, axis
    'i'."""
    if devices is None:
        devices = _default_devices()
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        axis_names = ("i", "j")[: len(shape)]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def _check_spec(shape, spec, mesh):
    """The JAX package's rule for a sharding: each sharded dimension
    divides evenly by the product of its mesh axes."""
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than the {len(shape)} "
                         f"dimensions of the value")
    for i, (size, entry) in enumerate(zip(shape, spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name not in mesh.shape:
                raise ValueError(f"{spec} names the axis {name!r}, which "
                                 f"{mesh} does not have")
        k = math.prod(mesh.shape[name] for name in names)
        if size % k:
            raise ValueError(
                f"a sharding of {spec} over {mesh} implies that the global "
                f"size of dimension {i} should be divisible by {k}, but it "
                f"is equal to {size} (full shape: {tuple(shape)})")


def _place(x, mesh, spec):
    _check_spec(tuple(x.shape), spec, mesh)
    dev = mesh.devices.flat[0]
    x._set_store(x._vals.to(dev), x._valid.to(dev))
    return x


def shard_matrix(A, mesh, spec=None):
    """Distribute a Matrix over the mesh (row blocks by default).

    A sparse-backed matrix gets row blocks over the mesh's first axis
    (``A._dist``, a BlockedCSR); mxv/vxm, the reduces, the masked SpGEMM
    and extract then run block by block.  A dense-backed matrix (or one
    given a `spec`) is placed whole on the mesh's first device; its row
    count must divide evenly by the mesh axis size (pad with ``A.resize``
    first if needed)."""
    if A._sparse is not None and spec is None:
        A._dist = make_blocked_csr(A, mesh)
        return A
    if spec is None:
        spec = P(mesh.axis_names[0], None)
    return _place(A, mesh, spec)


def shard_vector(v, mesh, spec=None):
    """Place a Vector for the mesh's first axis (or replicated, P()): whole
    on the mesh's first device; a sharded size must divide evenly."""
    if spec is None:
        spec = P(mesh.axis_names[0])
    return _place(v, mesh, spec)


def replicate(v, mesh):
    return shard_vector(v, mesh, P())


def ewise_blocked(A, B, op, *, variant="mult", name=None):
    """Element-wise over two shard_matrix()-ed matrices of one structure:
    the result carries a sparse store and row blocks of its own, each
    block op(A's block, B's block) with no communication."""
    from ..core.dtypes import unify
    from ..core.operator.base import typed
    from .ops import dist_ewise_same_structure

    if getattr(A, "_dist", None) is None or getattr(B, "_dist", None) is None:
        raise ValueError("ewise_blocked requires shard_matrix()-ed operands")
    if A._sparse is None or B._sparse is None or \
            A._sparse.struct is not B._sparse.struct:
        raise ValueError("ewise_blocked requires identical structure "
                         "(same-build matrices); use ewise_add/mult for "
                         "the general case")
    if getattr(op, "opclass", None) == "Monoid":
        op = op.binaryop
    bop = typed(op, unify(A.dtype, B.dtype), "BinaryOp")
    expr = A.ewise_mult(B, bop) if variant == "mult" else \
        A.ewise_add(B, bop)
    out = expr.new(name=name)
    out._dist = dist_ewise_same_structure(A._dist, B._dist, bop, A.dtype,
                                          B.dtype, out.dtype)
    return out
