"""Spans and counters of the port, read through ``torch.profiler``.

A span is a host range opened with ``torch.profiler.record_function``
while the profiler records: it lands in the profiler's trace (a
``user_annotation`` event of its Chrome trace) beside the kernels, copies
and synchronise calls it launched, on the same clock.  Off the profiler a
span costs one check of ``torch.autograd.profiler._is_profiler_enabled``:
no range is entered and no name is built.
There is no option and no exporter: run any code under
``torch.profiler.profile`` and the ranges appear.

Spans, by layer (their names are fixed strings):

- ``gb.algo:<function>``: each call of a public function of
  ``algorithms/`` (``bfs_level``, ``bfs_parent``, ``sssp``, ``pagerank``,
  ``triangle_count``, ``connected_components``); the spans of the call
  nest inside it.
- ``gb.op:<method>``: the frontend's dispatches (``execute.materialize``,
  ``update_into``, ``assign_update``, ``delete_region``) and the public
  reads and writes that reach the device (``to_dense``, ``to_coo``,
  ``value``, ``nvals``, ``isequal``, ``setitem``, ``get``, ``contains``).
  One may nest in another (``materialize`` calls ``update_into``).
- ``gb.engine:<engine>``: execute.py's dispatch into an engine:
  ``lanepipe`` (its plan lookup included), ``sortpipe``, ``sparse`` (the
  generic sparse engine, ``engine/sparse.py``), ``dense``, ``tropical``
  (K7, inside the dense engine's product) and ``parallel`` (the row
  blocks of ``gb.parallel``).
- ``gb.sync:<site>``: every call that makes the host wait for the
  device (:func:`read`): a read (``.item()``, ``.tolist()``, a copy to
  the host, ``bool()``/``int()`` of a device tensor, ``nonzero`` and the
  other operations whose output size depends on the data), a copy of host
  data to the device (from pageable memory it synchronises the stream,
  :func:`upload`, :func:`put`), and the ``torch.cuda.synchronize`` of
  ``init(blocking=True)`` and ``wait()``.  ``<site>`` names the call
  site, ``<module>.<what>``.
- ``spgemm:<formulation>:terms=<t>:gustavson=<g>:dot=<d>``: the sparse
  product's choice (``execute._spgemm_run``, ``execute.spgemm_record``),
  inside ``gb.engine:sparse``.
- ``lanepipe:sparse``: the lanepipe's sparse-vector branch, from after
  the ``lanepipe.u_valid_all`` read to the return of
  ``lanepipe.spmv_pipeline`` (K1 with its validity output, the
  two-channel route, the mask fold, K5, the extract and the tail), inside
  ``gb.engine:lanepipe``.  ``lanepipe:tail``: each call of the two-level
  tail, which recombines destinations split over ``lanepipe.SPLIT_DEG``
  entries, on any branch whose plan is two-level.
- ``sssp:round``: each Bellman-Ford iteration of ``algorithms.sssp``,
  inside ``gb.algo:sssp``.

Counters, always on:

- :data:`counts` holds the host-plan counters, added to at each plan
  built (a miss of ``lanepipe.get_plan`` or ``sortpipe.get_plan``), never
  on a plan found in the cache: ``plan.build_s``, the host seconds of the
  miss (the lanepipe: the host copy of the coordinates,
  ``lanepipe.build_plan``, both ``permute.build_perm_plan`` and the
  upload; the sort pipeline: ``build_plan_device`` until its plan is
  ready); ``plan.perm_s``, the part of that in
  ``permute.build_perm_plan``; ``plan.bytes``, the bytes of the device
  tensors the plan holds, with the truth-value twins that
  ``execute._plan`` adds to it.  It also holds the masked dot's, added
  to at each call of ``engine/sparse.masked_dot_slots``:
  ``masked_dot.entries``, the mask
  entries of every masked dot; ``masked_dot.kernel_entries``, those whose
  matching terms K8 (or its plain version on the CPU) counted, under a
  ``pair`` ring (``sparse.dot_by_counts``).
  And the lanepipe's, added to at each ``lanepipe.spmv_pipeline`` call:
  ``lanepipe.sparse_calls``, the calls that took the sparse-vector
  branch; ``lanepipe.tail_calls``, the calls that ran the two-level tail.
- ``kernels.launches`` (``engine/kernels.py``): hand-kernel launches by
  kernel.
- ``permute.exchanges`` (``engine/permute.py``): exchange transposes run
  by the plain versions of K2 and K3.
"""

import collections
import functools

import torch
from torch.autograd import profiler as _profiler

_record = torch.profiler.record_function


class _Off:
    """The context a span is off the profiler: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()

# the host-plan, masked-dot and lanepipe counters (see the module's
# docstring)
counts = collections.Counter()


def span(name, *args):
    """The profiler range ``name`` (with ``args``, ``name.format(*args)``,
    built only while the profiler records); a shared no-op context when
    it does not record."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _record(name.format(*args) if args else name)


def sync(site):
    """The range ``gb.sync:<site>`` around a host read of the device."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _record("gb.sync:" + site)


def read(site, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that waits for the device (a read,
    a synchronise, an operation whose output size depends on the data),
    inside the range ``gb.sync:<site>``.  Every such call of the port goes
    through here, so each one can be found by its site."""
    if not _profiler._is_profiler_enabled:
        return fn(*args, **kwargs)
    with sync(site):
        return fn(*args, **kwargs)


def nonzero(site, t):
    """The flat indices of ``t``'s nonzero elements (a read: their number
    decides the output's size)."""
    return read(site, torch.nonzero, t).reshape(-1)


def to_host(site, t):
    """A tensor's copy on the host, as numpy."""
    return read(site, t.detach().cpu).numpy()


def upload(site, t, device):
    """A host tensor's copy on ``device``: a copy from pageable host
    memory waits for the device's stream before it returns."""
    return read(site, t.to, device)


def put(site, t, index, value):
    """``t[index] = value`` for an index tensor and a Python scalar
    ``value``: the value is copied to ``t``'s device before the put."""
    read(site, t.__setitem__, index, value)


def spanned(name):
    """Decorate a function to run inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _record(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def tensor_bytes(obj):
    """Bytes of the tensors in ``obj`` and in the dicts, lists and tuples
    it holds."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return 0
    return sum(tensor_bytes(x) for x in obj)
