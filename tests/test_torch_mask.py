"""The reference's mask cases against the port (the twin of
tests/test_mask.py): write semantics, ``Mask.new``, and ``&``/``|`` over
every pair of the four mask kinds, on Vector and Matrix parents, run on
the CPU; and the 64 pairs over sparse-backed parents, which the port
combines without a dense plane, against the JAX package."""

import itertools

import numpy as np
import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from tests.test_torch_operator_grids import twin

twin("test_mask", globals())


def _parents(gb, mask_dtype):
    """Two 6 x 7 matrices whose values are 0 at some stored positions."""
    rng = np.random.default_rng(17)
    out = []
    for _ in range(2):
        r, c = np.nonzero(rng.random((6, 7)) < 0.5)
        vals = rng.integers(0, 2, len(r)) * 10
        out.append(gb.Matrix.from_coo(r, c, vals.astype(mask_dtype),
                                      nrows=6, ncols=7))
    return out


def _masks(a, b):
    return [a.S, a.V, ~a.S, ~a.V, b.S, b.V, ~b.S, ~b.V]


@pytest.mark.parametrize("how", ["and", "or"])
@pytest.mark.parametrize("mask_dtype", [bool, np.int64])
def test_sparse_mask_algebra_pairs(how, mask_dtype):
    """``m1 & m2`` and ``m1 | m2`` over all 64 pairs of masks of two
    sparse-backed matrices: ``new()`` and the write set of ``C(m) << 1``
    equal the JAX package's, and a combination that is not complemented
    stays sparse-backed."""
    ja, jb = _parents(gbj, mask_dtype)
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        ta, tb = _parents(gbt, mask_dtype)
        assert ta._sparse is not None
        for (jm1, jm2), (tm1, tm2) in zip(
                itertools.product(_masks(ja, jb), repeat=2),
                itertools.product(_masks(ta, tb), repeat=2)):
            jm = jm1 & jm2 if how == "and" else jm1 | jm2
            tm = tm1 & tm2 if how == "and" else tm1 | tm2
            want = jm.new()
            got = tm.new()
            assert got.dtype == want.dtype
            for g, w in zip(got.to_coo(), want.to_coo()):
                np.testing.assert_array_equal(g, w)
            if not tm.complement:
                assert tm.parent._sparse is not None
            jc = gbj.Matrix.from_scalar(1, 6, 7)
            jw = gbj.Matrix(gbj.dtypes.INT64, 6, 7)
            jw(jm) << jc
            tc = gbt.Matrix.from_scalar(1, 6, 7)
            tw = gbt.Matrix(gbt.dtypes.INT64, 6, 7)
            tw(tm) << tc
            for g, w in zip(tw.to_coo(), jw.to_coo()):
                np.testing.assert_array_equal(g, w)
