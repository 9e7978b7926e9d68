"""The reference's collection-protocol cases against the port (the twin
of tests/test_collection_protocols.py: no ``bool``, ``==`` as an
element-wise expression, no implicit array conversion, autocompute), run
on the CPU.  ``test_weakref_supported`` is left out: it asserts that a
Scalar made inside a call outlives the call (garbage collection, not this
surface)."""

from tests.test_torch_operator_grids import twin

twin("test_collection_protocols", globals(), only=(
    "test_no_bool_on_collections", "test_eq_returns_elementwise_matrix",
    "test_contains", "test_iter_yields_indices",
    "test_not_implicitly_to_array", "test_get_with_default",
    "test_ndim_and_shape", "test_incompatible_shapes_raise",
    "test_bad_update_target", "test_assign_transposed_source",
    "test_nested_expression_evaluation", "test_expr_is_like_matrix",
    "test_index_expr_is_like_matrix", "test_wait_chains",
    "test_delete_via_scalar_assign", "test_dup_expression",
    "test_to_coo_sort_and_subset", "test_bool_matrix_used_as_mask",
    "test_scalar_expressions_bool_ok", "test_vector_inner_outer",
    "test_diag_roundtrip"))
