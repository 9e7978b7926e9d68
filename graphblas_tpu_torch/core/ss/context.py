"""Execution Context (graphblas_tpu/core/ss/context.py): a context
manager with a thread-local engage/disengage stack and a mapping interface
over ``nthreads``, ``chunk``, ``gpu_id`` and ``device``.  In the port
``device`` names a torch device (``"cuda"``, ``"cpu"``; None: the
configured one); the keys are kept and read back and change nothing (a
CUDA kernel's parallelism is its launch shape), as the JAX package keeps
them."""

import threading


class ThreadLocal(threading.local):
    def __init__(self):
        self.stack = []


_tls = ThreadLocal()


class Context:
    """A config mapping that is also a context manager (engage)."""

    __slots__ = ("nthreads", "chunk", "gpu_id", "device", "_engaged",
                 "__weakref__")

    _keys = ("nthreads", "chunk", "gpu_id", "device")

    def __init__(self, engage=True, *, nthreads=None, chunk=None, gpu_id=None,
                 device=None, stack=True):
        import os

        self.nthreads = nthreads if nthreads is not None else (
            os.cpu_count() or 1)
        self.chunk = chunk if chunk is not None else 65536
        self.gpu_id = -1 if gpu_id is None else gpu_id
        self.device = device
        self._engaged = False
        if engage:
            self.engage()

    def engage(self):
        if not self._engaged:
            _tls.stack.append(self)
            self._engaged = True

    def disengage(self):
        if self._engaged:
            try:
                _tls.stack.remove(self)
            except ValueError:
                pass
            self._engaged = False

    def __enter__(self):
        self.engage()
        return self

    def __exit__(self, *exc):
        self.disengage()
        return False

    # the mapping interface
    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(f"Invalid config name: {key}")
        return getattr(self, key)

    def __setitem__(self, key, value):
        if key not in self._keys:
            raise KeyError(f"Invalid config name: {key}")
        setattr(self, key, value)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __contains__(self, key):
        return key in self._keys

    def keys(self):
        return list(self._keys)

    def values(self):
        return [getattr(self, k) for k in self._keys]

    def items(self):
        return [(k, getattr(self, k)) for k in self._keys]

    def get(self, key, default=None):
        return getattr(self, key) if key in self._keys else default

    def __repr__(self):
        return (f"Context(nthreads={self.nthreads}, chunk={self.chunk}, "
                f"device={self.device})")

    @property
    def _carg(self):
        return repr(self)


def current_context():
    if _tls.stack:
        return _tls.stack[-1]
    return global_context


global_context = Context(engage=False)
