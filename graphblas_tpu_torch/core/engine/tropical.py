"""Dense tropical matrix product: kernel K7 and its plain version.

``C[i,j] = red_k comb(A[i,k], B[k,j])`` with red in {min, max} and comb in
{plus, min, max, times, first, second}, over float32 or float64
(graphblas_tpu/core/engine/kernels/tropical.py).  The JAX package keeps
its kernels in a ``kernels/`` folder; in the port ``kernels.py`` is the
nvcc loader, so this kernel module sits beside ``lanepipe.py`` and its
source is ``csrc/tropical.cu``.

Two ways to say "no entry":

* encoded, as the Pallas kernel takes it: a missing entry holds red's
  identity (+inf for min, -inf for max).  That is exact only for
  (min|max, plus), (min, max) and (max, min), and only while no stored
  value is an infinity of the other sign or a NaN.
* with the validity planes ``a_valid``/``b_valid``: a pair with a missing
  operand is skipped, whatever the values hold.  This is what
  ``dense.semiring_matmul`` calls for the four semirings above; its
  ``fmin``/``fmax`` combines are the GraphBLAS binary ``min``/``max``.

min and max as red, and as comb under their own names, propagate NaN like
``jnp.minimum``/``torch.minimum``.  The JAX package's blocked scan reduces
each k-block with ``jnp.min`` (NaN wins) and joins blocks with ``fmin``
(NaN loses), so there a NaN's fate depends on the block size; here a NaN
product always poisons its output.
"""

import torch

from . import kernels as K

_COMBINE = {
    "plus": lambda a, b: a + b,
    "min": torch.minimum,
    "max": torch.maximum,
    "times": lambda a, b: a * b,
    "first": lambda a, b: a.expand(torch.broadcast_shapes(a.shape, b.shape)),
    "second": lambda a, b: b.expand(torch.broadcast_shapes(a.shape, b.shape)),
    "fmin": torch.fmin,
    "fmax": torch.fmax,
}
_REDUCE = {
    "min": (torch.minimum, torch.amin, float("inf")),
    "max": (torch.maximum, torch.amax, float("-inf")),
}
# codes of csrc/tropical.cu
RED_CODE = {"min": 0, "max": 1}
COMB_CODE = {"plus": 0, "min": 1, "max": 2, "times": 3, "first": 4,
             "second": 5, "fmin": 6, "fmax": 7}
# (red, comb) pairs the entry point with validity planes is built for
MASKED_PAIRS = (("min", "plus"), ("max", "plus"), ("min", "fmax"),
                ("max", "fmin"))

plain_calls = 0  # runs of the plain version since import (a CUDA run shows 0)


def available():
    """True when the kernel can run: a CUDA device is present."""
    return torch.cuda.is_available()


def _check(a, b, reduce_name, combine_name, a_valid, b_valid):
    if reduce_name not in _REDUCE or combine_name not in _COMBINE:
        raise ValueError(f"tropical_matmul: no ({reduce_name}, "
                         f"{combine_name}) product")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tropical_matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tropical_matmul: operands must both be float32 or "
                        f"float64; got {a.dtype}, {b.dtype}")
    if (a_valid is None) != (b_valid is None):
        raise ValueError("tropical_matmul: give both validity planes or none")
    if a_valid is not None:
        if a_valid.shape != a.shape or b_valid.shape != b.shape:
            raise ValueError("tropical_matmul: a validity plane has another "
                             "shape than its operand")
        if a_valid.dtype != torch.bool or b_valid.dtype != torch.bool:
            raise TypeError("tropical_matmul: validity planes must be bool")
        if (reduce_name, combine_name) not in MASKED_PAIRS:
            raise ValueError(f"tropical_matmul: ({reduce_name}, "
                             f"{combine_name}) has no entry point with "
                             f"validity planes; it has {MASKED_PAIRS}")


def tropical_matmul_plain(a, b, reduce_name="min", combine_name="plus",
                          a_valid=None, b_valid=None):
    """Plain version of K7 (see :func:`tropical_matmul`): the product
    blocked over k so that the (m, bk, n) intermediate stays bounded, as
    ``tropical_matmul_reference`` of the JAX package does."""
    global plain_calls
    _check(a, b, reduce_name, combine_name, a_valid, b_valid)
    plain_calls += 1
    red, red_axis, ident = _REDUCE[reduce_name]
    comb = _COMBINE[combine_name]
    m, k = a.shape
    n = b.shape[1]
    bk = max(1, min(k, (1 << 22) // max(1, m * n)))
    out = torch.full((m, n), ident, dtype=a.dtype, device=a.device)
    for k0 in range(0, k, bk):
        pv = comb(a[:, k0:k0 + bk, None], b[None, k0:k0 + bk, :])
        if a_valid is not None:
            ok = a_valid[:, k0:k0 + bk, None] & b_valid[None, k0:k0 + bk, :]
            pv = torch.where(ok, pv, ident)
        out = red(out, red_axis(pv, dim=1))
    return out


def tropical_matmul(a, b, reduce_name="min", combine_name="plus",
                    a_valid=None, b_valid=None):
    """Dense tropical product (kernel K7).

    a: (m, k), b: (k, n), both float32 or both float64, row-major; returns
    (m, n).  Without validity planes a missing entry is encoded as red's
    identity; with them (bool, the operands' shapes) pairs with a missing
    operand are skipped and an output with no pair holds the identity.  No
    shape has to divide the kernel's tile.  One launch; see
    csrc/tropical.cu."""
    if a.device.type == "cpu":
        return tropical_matmul_plain(a, b, reduce_name, combine_name,
                                     a_valid, b_valid)
    _check(a, b, reduce_name, combine_name, a_valid, b_valid)
    K.require_cuda("tropical_matmul", [a, b], word=a.element_size())
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 1 << 31:
        raise ValueError("tropical_matmul: a dimension exceeds 2**31 - 1")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    tail = (m, n, k, RED_CODE[reduce_name], COMB_CODE[combine_name],
            int(a.dtype == torch.float64), K.stream_ptr(a))
    lib = K.lib("tropical")
    if a_valid is None:
        rc = lib.tropical_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 *tail)
    else:
        K.require_cuda("tropical_matmul", [a, a_valid, b_valid], word=None)
        rc = lib.tropical_matmul_masked(
            a.data_ptr(), b.data_ptr(), a_valid.data_ptr(),
            b_valid.data_ptr(), out.data_ptr(), *tail)
    K.check("tropical_matmul", rc)
    K.launches["tropical_matmul"] += 1
    return out
