"""The reference's repr tests against the port (the twin of
tests/test_formatting.py), run on the CPU: the text is byte for byte the
JAX package's."""

from tests.test_torch_operator_grids import twin

twin("test_formatting", globals())
