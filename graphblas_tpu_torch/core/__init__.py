"""The port's core.  ``init`` (graphblas_tpu_torch/__init__.py) sets the
execution mode here: ``_blocking`` makes every dispatch of
core/execute.py wait for the card."""

_init_params = None
_blocking = None
