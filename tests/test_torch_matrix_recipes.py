"""The reference's Matrix recipes against the port (the twin of
tests/test_matrix_recipes.py), run on the CPU."""

from tests.test_torch_operator_grids import twin

twin("test_matrix_recipes", globals())
