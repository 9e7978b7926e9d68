"""Recorder (graphblas_tpu/core/recorder.py): a context-local record of
every dispatch of core/execute.py, one line a call (method, output, mask,
accum, replace, op and operands; ``execute._record_line``), the same lines
the JAX package writes for the same calls."""

import contextvars

_recorder_stack = contextvars.ContextVar("recorder_stack", default=None)


def record(line):
    rec = _recorder_stack.get()
    if rec is not None:
        if callable(line):  # lazy: hot paths defer string building
            line = line()
        rec.data.append(line)


def recording():
    """True when a Recorder is active (lets hot paths skip work)."""
    return _recorder_stack.get() is not None


def gbstr(obj):
    name = getattr(obj, "name", None)
    if name:
        return name
    return repr(obj)


class Recorder:
    """Record engine dispatches.

    >>> with gb.Recorder() as rec:
    ...     C(mask.S) << A.mxm(B, semiring.min_plus)
    >>> rec.data
    ['mxm(C, mask=M.S, accum=None, replace=False, op=min_plus, A, B)']
    """

    __slots__ = "data", "_token", "_active", "max_rows", "__weakref__"

    def __init__(self, *, start=True, max_rows=None):
        self.data = []
        self._token = None
        self._active = False
        self.max_rows = max_rows
        if start:
            self.start()

    @property
    def is_recording(self):
        return self._active

    def start(self):
        if not self._active:
            self._token = _recorder_stack.set(self)
            self._active = True

    def stop(self):
        if self._active:
            _recorder_stack.reset(self._token)
            self._token = None
            self._active = False

    def clear(self):
        self.data.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __repr__(self):
        lines = self.data
        if self.max_rows is not None and len(lines) > self.max_rows:
            half = self.max_rows // 2
            shown = lines[:half] + ["..."] + lines[-half:]
        else:
            shown = lines
        body = "\n".join(shown)
        status = "recording" if self._active else "stopped"
        return f"Recorder ({status}; {len(lines)} calls)\n{body}"

    def _repr_markdown_(self):
        body = "\n".join(f"    {line}" for line in self.data)
        return f"**Recorder** ({len(self.data)} calls)\n\n{body}"
