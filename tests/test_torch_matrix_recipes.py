"""The reference's Matrix recipes against the port (the twin of
tests/test_matrix_recipes.py), run on the CPU.  ``gb.ss.diag`` and
``Matrix.ss`` (split and concat) wait for item 12."""

from tests.test_torch_operator_grids import twin

twin("test_matrix_recipes", globals(), not_ported=(
    "test_diag_roundtrip", "test_split_concat"))
