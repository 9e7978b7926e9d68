"""The reference's golden reprs against the port (the twin of
tests/test_formatting_goldens.py), run on the CPU: every golden text byte
for byte, the FC64 and user-defined-type collections included."""

from tests.test_torch_operator_grids import twin

twin("test_formatting_goldens", globals())
