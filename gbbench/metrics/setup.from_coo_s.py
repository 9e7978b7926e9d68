"""Seconds of ``Matrix.from_coo`` on the generated coordinates, until
``wait()`` returns: the constructors (``core/matrix.py``,
``core/engine/store.py``)."""


def read(run):
    return run.from_coo_s
