"""The reference's Matrix cases against the port (the twin of
tests/test_matrix.py: construction from COO, edge lists, CSR/CSC and
dicts, ``build`` with ``dup_op``, the exports, and the operations), run on
the CPU with the same inputs and expected values."""

from tests.test_torch_operator_grids import twin

twin("test_matrix", globals())
