"""Text and HTML reprs (graphblas_tpu/core/formatting.py): the same text,
byte for byte, as the JAX package's on the same objects.

Small collections render as aligned grids; a window of at most 12 rows
and 14 columns (the middle elided) is shown.  A grid reads only the cells
of its window: a dense-backed collection gathers those cells on its
device, a sparse-backed one takes the entries of its COO store whose row
and column fall in the window, so a sparse store is never densified.  A
sparse matrix over ``dense_limit`` elements prints its first entries
instead of a grid, as in the JAX package."""

import numpy as np
import torch

from . import dtypes as _dt
from . import trace as _trace

_MAX_ROWS = 12
_MAX_COLS = 14


def _fmt_val(v, dtype):
    if dtype.is_float:
        return f"{v:.6g}"
    if dtype.is_complex:
        return f"{v:.4g}"
    if dtype.is_bool:
        return "True" if v else "False"
    return str(v)


def format_scalar(s):
    header = f'"{s.name}"' if s.name else "gb.Scalar"
    val = s.value
    vs = "(empty)" if val is None else _fmt_val(val, s.dtype)
    return f"{header}\nvalue: {vs}\ndtype: {s.dtype.name}"


def _window(n, maxn):
    """Indices shown along an axis of n: all, or the first and last
    maxn // 2 around None (the ellipsis)."""
    if n <= maxn:
        return list(range(n))
    half = maxn // 2
    return list(range(half)) + [None] + list(range(n - half, n))


def _cells(obj, rows_w, cols_w, transposed=False):
    """{(row, col): value} of the stored elements of obj (a Matrix, or a
    Vector as one row) inside the window; transposed reads a Matrix's
    transpose."""
    want_r = np.array([i for i in rows_w if i is not None], np.int64)
    want_c = np.array([j for j in cols_w if j is not None], np.int64)
    if obj.ndim == 1:
        idx, vals = obj.to_coo()
        r, c = np.zeros(len(idx), np.int64), idx.astype(np.int64)
    elif obj._sparse is not None:
        r, c, vals = obj._sparse.host_coo()
    else:  # the window's cells only, gathered on the device
        rr, cc = (want_c, want_r) if transposed else (want_r, want_c)
        ri, ci = (_trace.upload("formatting.window", torch.from_numpy(x),
                                obj.device) for x in (rr, cc))
        ok = _trace.to_host("formatting.window", obj._d_valid[ri][:, ci])
        r, c = np.nonzero(ok)
        vals = _dt.to_numpy(obj._d_vals[ri][:, ci], obj.dtype)[r, c]
        r, c = rr[r], cc[c]
    if transposed:
        r, c = c, r
    keep = np.isin(r, want_r) & np.isin(c, want_c)
    return dict(zip(zip(r[keep].tolist(), c[keep].tolist()), vals[keep]))


def _grid_cells(nrows, ncols, is_vector):
    return ([0] if is_vector else _window(nrows, _MAX_ROWS),
            _window(ncols, _MAX_COLS))


def _grid(cells, dtype, rows_w, cols_w):
    table = [[""] + ["..." if j is None else str(j) for j in cols_w]]
    for i in rows_w:
        if i is None:
            table.append(["..."] * len(table[0]))
            continue
        row = [str(i)]
        for j in cols_w:
            if j is None:
                row.append("...")
            else:
                v = cells.get((i, j))
                row.append("" if v is None else _fmt_val(v, dtype))
        table.append(row)
    widths = [max(len(r[k]) for r in table) for k in range(len(table[0]))]
    return "\n".join("  ".join(val.rjust(w) for val, w in zip(r, widths))
                     for r in table)


def _header(name, type_lines, cols):
    """The aligned header: name and column labels, then the type lines
    with the values on the last one.  Returns (text, width of line 1)."""
    left = max(len(name), *(len(t) for t in type_lines))
    widths = [max(len(lbl), len(val)) for lbl, val in cols]
    line1 = name.ljust(left) + "".join(
        "  " + lbl.rjust(w) for (lbl, _), w in zip(cols, widths))
    out = [line1] + list(type_lines[:-1])
    out.append(type_lines[-1].ljust(left) + "".join(
        "  " + val.rjust(w) for (_, val), w in zip(cols, widths)))
    return "\n".join(out), len(line1)


def _with_grid(header, width, obj, dtype, nrows, ncols, *, transposed=False,
               shown=None):
    """header, a rule and the window's grid; shown maps the stored values
    to what is printed (a mask's 0/1).  A user-defined type shows the
    header alone, as in the JAX package."""
    if nrows == 0 or ncols == 0 or obj.dtype._is_udt:
        return header
    is_vector = obj.ndim == 1
    rows_w, cols_w = _grid_cells(nrows, ncols, is_vector)
    cells = _cells(obj, rows_w, cols_w, transposed)
    if shown is not None:
        cells = {k: shown(v) for k, v in cells.items()}
    return f"{header}\n{'-' * width}\n{_grid(cells, dtype, rows_w, cols_w)}"


def _too_big(m):
    from .config import config

    return m._sparse is not None and \
        m.nrows * m.ncols > int(config.get("dense_limit", 1 << 26))


def _sparse_summary(header, sp, max_entries=10):
    """The first entries of a graph-scale sparse store, one a line."""
    k = min(max_entries, sp.nvals())
    r = _trace.to_host("formatting.summary", sp.rows[:k])
    c = _trace.to_host("formatting.summary", sp.cols[:k])
    vals = [str(x.item() if hasattr(x, "item") else x)
            for x in _dt.to_numpy(sp.vals[:k], sp.dtype)]
    lines = [f"  ({i}, {j})\t{v}" for i, j, v in zip(r, c, vals)]
    if len(lines) == max_entries:
        lines.append("  ...")
    return header + "\n" + "\n".join(lines)


def format_vector(v, type_name="gb.Vector"):
    name = f'"{v.name}"' if v.name else type_name
    header, w = _header(
        name, [type_name],
        [("nvals", str(v.nvals)), ("size", str(v.size)),
         ("dtype", v.dtype.name), ("format", v.ss.format)])
    return _with_grid(header, w, v, v.dtype, 1, v.size)


def format_matrix(m, type_name="gb.Matrix"):
    name = f'"{m.name}"' if m.name else type_name
    header, w = _header(
        name, [type_name],
        [("nvals", str(m.nvals)), ("nrows", str(m.nrows)),
         ("ncols", str(m.ncols)), ("dtype", m.dtype.name),
         ("format", m.ss.format)])
    if m.nrows == 0 or m.ncols == 0 or m.dtype._is_udt:
        return header
    if _too_big(m):
        return _sparse_summary(header, m._sparse)
    return _with_grid(header, w, m, m.dtype, m.nrows, m.ncols)


def format_transposed(t):
    """``A.T``: the transposed grid under a gb.TransposedMatrix header."""
    m = t._matrix
    name = f'"{m.name}.T"' if m.name else "gb.TransposedMatrix"
    header, w = _header(
        name, ["gb.TransposedMatrix"],
        [("nvals", str(m.nvals)), ("nrows", str(t.nrows)),
         ("ncols", str(t.ncols)), ("dtype", m.dtype.name),
         ("format", "bitmapc")])
    if t.nrows == 0 or t.ncols == 0 or m.dtype._is_udt:
        return header
    if _too_big(m):
        return _sparse_summary(header, m._sparse)
    return _with_grid(header, w, m, m.dtype, t.nrows, t.ncols,
                      transposed=True)


_MASK_CLASS = {
    (False, True): "StructuralMask",
    (False, False): "ValueMask",
    (True, True): "ComplementedStructuralMask",
    (True, False): "ComplementedValueMask",
}


def format_mask(mask):
    """A mask: 0/1 at the parent's stored positions, whether the mask
    passes there."""
    from .dtypes import INT64

    parent = mask.parent
    is_vector = parent.ndim == 1
    prefix = "~" if mask.complement else ""
    suffix = "S" if mask.structure else "V"
    pname = parent.name or ("v" if is_vector else "M")
    name = f'"{prefix}{pname}.{suffix}"'
    mask_cls = _MASK_CLASS[(mask.complement, mask.structure)]
    type_label = f"of gb.{'Vector' if is_vector else 'Matrix'}"
    if is_vector:
        cols = [("nvals", str(parent.nvals)), ("size", str(parent.size)),
                ("dtype", parent.dtype.name), ("format", parent.ss.format)]
        nrows, ncols = 1, parent.size
    else:
        cols = [("nvals", str(parent.nvals)), ("nrows", str(parent.nrows)),
                ("ncols", str(parent.ncols)), ("dtype", parent.dtype.name),
                ("format", parent.ss.format)]
        nrows, ncols = parent.nrows, parent.ncols
    header, w = _header(name, [mask_cls, type_label], cols)

    def shown(v):
        passes = True if mask.structure else v != 0
        return int(passes) ^ int(mask.complement)

    return _with_grid(header, w, parent, INT64, nrows, ncols, shown=shown)


def _html_grid(cells, dtype, rows_w, cols_w):
    head = "".join("<th>...</th>" if j is None else f"<th>{j}</th>"
                   for j in cols_w)
    rows_html = [f"<tr><th></th>{head}</tr>"]
    for i in rows_w:
        if i is None:
            rows_html.append(
                "<tr><th>...</th>" + "<td>...</td>" * len(cols_w) + "</tr>")
            continue
        tds = []
        for j in cols_w:
            if j is None:
                tds.append("<td>...</td>")
                continue
            v = cells.get((i, j))
            tds.append(f"<td>{'' if v is None else _fmt_val(v, dtype)}</td>")
        rows_html.append(f"<tr><th>{i}</th>{''.join(tds)}</tr>")
    return "<table>" + "".join(rows_html) + "</table>"


def format_matrix_html(m, mask=None):
    name = m.name or "gb.Matrix"
    header = (f"<b>{name}</b> — nvals={m.nvals}, nrows={m.nrows}, "
              f"ncols={m.ncols}, dtype={m.dtype.name}, format=bitmap")
    if m.nrows == 0 or m.ncols == 0 or m.dtype._is_udt:
        return f"<div>{header}</div>"
    if _too_big(m):
        body = _sparse_summary("", m._sparse).replace("\n", "<br>")
        return f"<div>{header}<pre>{body}</pre></div>"
    rows_w, cols_w = _grid_cells(m.nrows, m.ncols, False)
    grid = _html_grid(_cells(m, rows_w, cols_w), m.dtype, rows_w, cols_w)
    return f"<div>{header}{grid}</div>"


def format_vector_html(v, mask=None):
    name = v.name or "gb.Vector"
    header = (f"<b>{name}</b> — nvals={v.nvals}, size={v.size}, "
              f"dtype={v.dtype.name}")
    if v.size == 0 or v.dtype._is_udt:
        return f"<div>{header}</div>"
    rows_w, cols_w = _grid_cells(1, v.size, True)
    grid = _html_grid(_cells(v, rows_w, cols_w), v.dtype, rows_w, cols_w)
    return f"<div>{header}{grid}</div>"


def format_scalar_html(s):
    val = s.value
    vs = _fmt_val(val, s.dtype) if val is not None else "(empty)"
    return (f"<div><b>{s.name or 'gb.Scalar'}</b> — value={vs}, "
            f"dtype={s.dtype.name}</div>")


# the scalars an expression binds (a bound operand, the union's two
# defaults, a thunk): the JAX package keeps them among its arguments, as
# arrays, and prints each by its array type's name
_BOUND_SCALARS = {"apply_bound": 1, "ewise_union": 2, "select": 1,
                  "apply_indexunary": 1}


def format_expression(expr):
    opname = getattr(expr.op, "name", None)
    names = [getattr(a, "name", None) or type(a).__name__ for a in expr.args]
    names += ["ArrayImpl"] * _BOUND_SCALARS.get(expr._kind, 0)
    inner = ", ".join(names)
    op_part = f", op={opname}" if opname else ""
    return (f"gb.{expr.output_type.__name__}Expression  "
            f"{expr.method_name}({inner}{op_part})  "
            f"dtype={expr.dtype.name}  shape={tuple(expr.shape)}\n"
            "Do expr.new() or `output << expr` to calculate the expression.")
