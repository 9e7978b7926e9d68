"""The reference's dup_op cases against the port (the twin of
tests/test_dup_op.py), run on the CPU with the same inputs and expected
values the JAX package meets there, ``Matrix.build``, ``from_edgelist``
and ``from_dicts`` included."""

from tests.test_torch_operator_grids import twin

twin("test_dup_op", globals())
