"""The reference's Vector cases against the port (the twin of
tests/test_vector.py: ``from_coo``, ``from_pairs``, ``from_dict``,
``build`` and its errors, ``resize``, ``outer``, the infix forms and the
operations), run on the CPU with the same inputs and expected values."""

from tests.test_torch_operator_grids import twin

twin("test_vector", globals())
