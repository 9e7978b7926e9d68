"""Native (C++) host-side helpers, reached via ctypes.

A copy of ``graphblas_tpu/native`` for the PyTorch package, which never
imports the JAX package.  ``builder.cpp`` (COO sorting and dedup) and
``permplan.cpp`` (Clos-route edge coloring) are compiled with ``g++`` at
first use into ``_build/`` beside this file, which ``.gitignore`` lists.
Every entry point has a numpy fallback, so the package works without a
compiler; :func:`permplan_loaded` tells a caller whether the fast coloring
is in use.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")

_libs = {}
_lock = threading.Lock()


def _load(stem, bind):
    """Build ``<stem>.cpp`` into ``_build/lib<stem>.so`` if stale, load it
    and declare its functions with ``bind(lib)``; None without a compiler.

    The build writes to a per-process file and renames it into place, so
    that parallel test workers never load a half-written library."""
    if stem in _libs:
        return _libs[stem]
    with _lock:
        if stem in _libs:
            return _libs[stem]
        src = os.path.join(_HERE, stem + ".cpp")
        so = os.path.join(_BUILD_DIR, f"lib{stem}.so")
        lib = None
        try:
            if not os.path.exists(so) or (
                    os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                                src, "-o", tmp],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            bind(lib)
        except (OSError, subprocess.SubprocessError):
            lib = None  # no toolchain: numpy fallbacks
        _libs[stem] = lib
        return lib


def _bind_builder(lib):
    lib.coo_argsort.restype = ctypes.c_int
    lib.coo_argsort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.coo_mark_unique.restype = ctypes.c_int64
    lib.coo_mark_unique.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]


def _bind_permplan(lib):
    lib.clos_color.restype = ctypes.c_int
    lib.clos_color.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.clos_color_counts.restype = ctypes.c_int
    lib.clos_color_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]


def get_lib():
    """The COO builder library, or None."""
    return _load("builder", _bind_builder)


def _get_permlib():
    return _load("permplan", _bind_permplan)


def permplan_loaded():
    """True when the native Clos coloring is available (else the Python
    Euler-split fallback runs, which is far too slow at graph scale)."""
    return _get_permlib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def coo_argsort(rows, cols, nrows, ncols):
    """Lexicographic argsort of (rows, cols); int64 arrays."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    n = len(rows)
    lib = get_lib()
    if lib is None or n < 4096:
        return np.lexsort((cols, rows))
    perm = np.empty(n, np.int64)
    rc = lib.coo_argsort(_ptr(rows), _ptr(cols), n, int(nrows), int(ncols),
                         _ptr(perm))
    if rc != 0:
        return np.lexsort((cols, rows))
    return perm


def coo_mark_unique(sorted_rows, sorted_cols):
    """uniq flags (uint8) + count for sorted coordinates."""
    sorted_rows = np.ascontiguousarray(sorted_rows, np.int64)
    sorted_cols = np.ascontiguousarray(sorted_cols, np.int64)
    n = len(sorted_rows)
    lib = get_lib()
    if lib is None or n < 4096:
        if n == 0:
            return np.zeros(0, np.uint8), 0
        flags = np.empty(n, np.uint8)
        flags[0] = 1
        flags[1:] = (np.diff(sorted_rows) != 0) | (np.diff(sorted_cols) != 0)
        return flags, int(flags.sum())
    flags = np.empty(n, np.uint8)
    uniq = lib.coo_mark_unique(_ptr(sorted_rows), _ptr(sorted_cols), n,
                               _ptr(flags))
    return flags, int(uniq)


# --------------------------------------------------------------------- #
# Clos-route planning (permplan.cpp): Euler-split edge coloring
def _clos_color_py(u, v, offs, m, d):
    """Pure-python Euler-split fallback (small graphs / no compiler)."""
    colors = np.empty(len(u), np.int32)

    def rec(eids, dd, c0):
        if dd == 1:
            colors[eids] = c0
            return
        ne = len(eids)
        uu = u[eids]
        vv = v[eids] + m
        # incidence as dict-of-lists (both endpoints of every edge)
        inc_u = {}
        for i in range(ne):
            inc_u.setdefault(uu[i], []).append(i)
            inc_u.setdefault(vv[i], []).append(i)
        cursor = {k: 0 for k in inc_u}
        side = np.full(ne, 2, np.int8)
        for start in range(ne):
            if side[start] != 2:
                continue
            i = start
            sd = 0
            at_left = True
            while True:
                side[i] = sd
                sd ^= 1
                node = vv[i] if at_left else uu[i]
                lst = inc_u[node]
                j = -1
                while cursor[node] < len(lst):
                    cand = lst[cursor[node]]
                    cursor[node] += 1
                    if side[cand] == 2:
                        j = cand
                        break
                if j < 0:
                    break
                i = j
                at_left = node < m
        h0 = eids[side == 0]
        h1 = eids[side == 1]
        rec(h0, dd // 2, c0)
        rec(h1, dd // 2, c0 + dd // 2)

    for g in range(len(offs) - 1):
        lo, hi = int(offs[g]), int(offs[g + 1])
        rec(np.arange(lo, hi, dtype=np.int64), d, 0)
    return colors


def clos_color(u, v, offs, m, d):
    """Edge-color regular bipartite multigraphs (degree d, power of two).

    u, v: int32 per-graph node ids in [0, m); offs: int64[ngraphs+1]
    partition of the edge arrays.  Returns int32 colors in [0, d), distinct
    within every left node and every right node of each graph.

    Edges between the same (u, v) pair are interchangeable, so the fast
    path Euler-splits the per-graph COUNT MATRIX and assigns the emitted
    per-cell color multisets to edges in (graph, cell)-sorted order.
    """
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    offs = np.ascontiguousarray(offs, np.int64)
    lib = _get_permlib()
    if lib is not None and len(u):
        ngraphs = len(offs) - 1
        cell = (u.astype(np.int32) * np.int32(m) + v).astype(np.int32)
        colors = np.empty(len(u), np.int32)
        rc = lib.clos_color_counts(_ptr(cell), _ptr(offs), ngraphs,
                                   int(m), int(d), _ptr(colors))
        if rc == 0:
            return colors
        colors = np.empty(len(u), np.int32)
        rc = lib.clos_color(_ptr(u), _ptr(v), _ptr(offs),
                            ngraphs, int(m), int(d), _ptr(colors))
        if rc == 0:
            return colors
    return _clos_color_py(u, v, offs, m, d)
