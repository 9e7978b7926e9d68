"""Build, load and count the hand-written CUDA kernels of csrc/.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface under ``csrc/_build/``
(listed in ``.gitignore``), and loaded with ctypes.  :func:`build` starts
one ``nvcc`` per source, all together, and is called at first use; nothing
is built when this module is imported, so the CPU tests import it freely.

Every C entry point that launches returns ``cudaGetLastError()``;
:func:`check` raises when it is not 0.  Each wrapper adds one to ``launches[<kernel>]`` per
kernel launch, so a run can show that the main path went through the
kernels.  The op and type codes here must match csrc/common.cuh (the
scans') and csrc/gather_mult.cu (K1's multiply, :func:`k1_code`).
"""

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
SOURCES = ("tile_perm", "mid_perm", "gather_mult", "fused_scan",
           "lane_segscan", "segscan", "tropical", "masked_dot")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel since the last reset, keyed by the kernel's name
# (fused_permC_scan_permA and lane_segscan one per call: the kernel, not
# the memset of its scratch before it; segscan one per group of channels;
# tropical_matmul counts both entry points of tropical.cu; masked_dot one
# per masked dot with terms, not the zero fill of its counts)
launches = collections.Counter()

DT = {"f32": 0, "i32": 1, "u32": 2, "bool": 3}
MONOID_OP = {"plus": 0, "times": 1, "min": 2, "max": 3, "lor": 4, "land": 5,
             "band": 6, "bor": 7, "lxor": 8, "lxnor": 9, "eq": 9, "bxor": 10}
# K1's operand types (gather_mult.cu T_*) and multiplies (OP_*): every
# builtin binary op of core/operator/binary.py's table but cmplx
K1_TYPE = {"FP32": 0, "INT32": 1, "UINT32": 2, "BOOL": 3, "INT8": 4,
           "INT16": 5, "UINT8": 6, "UINT16": 7}
K1_OP = {name: i for i, name in enumerate((
    "first", "second", "pair", "any", "plus", "minus", "rminus", "times",
    "cdiv", "rdiv", "truediv", "rtruediv", "min", "max", "pow", "iseq",
    "isne", "isgt", "islt", "isge", "isle", "lor", "land", "lxor", "lxnor",
    "bor", "band", "bxor", "bxnor", "bget", "bset", "bclr", "bshift", "atan2",
    "hypot", "fmod", "remainder", "ldexp", "copysign", "eq", "ne", "gt", "lt",
    "ge", "le"))}
# K1's templated multiplies: (op, type) with every type the same
K1_FAST = {("times", "FP32"): 1, ("plus", "FP32"): 2, ("land", "BOOL"): 3}
SEG_FIRST = 255  # segscan.cu's combine code for `first`
MAXCH = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tile_perm": [_P, _P, _P, _I, _I, _P],
    "tile_perm_channels": [],
    "mid_perm_tiles": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mid_perm_channels": [_I, _I, _I],
    "gather_mult": [_P] * 10 + [_I] * 7 + [_P],  # (ntiles, code, fast, ...)
    "fused_scan": [_P] * 6 + [_I] * 4 + [_P],
    "lane_segscan": [_P] * 6 + [_I] * 4 + [_P],
    "segscan": [_P] * 4 + [_I, _P, _I, _P],
    "tropical_matmul": [_P] * 3 + [_I] * 6 + [_P],
    "tropical_matmul_masked": [_P] * 5 + [_I] * 6 + [_P],
    "masked_dot": [_P] * 8 + [_I, _I, ctypes.c_longlong, _P],
}
# C entry points of a source, where they are not the one named after it
_ENTRY_POINTS = {"tropical": ("tropical_matmul", "tropical_matmul_masked"),
                 "tile_perm": ("tile_perm", "tile_perm_channels"),
                 "mid_perm": ("mid_perm_tiles", "mid_perm_channels")}

_libs = {}
_lock = threading.Lock()
build_log = {}
build_secs = {}  # seconds from the start of build() until each nvcc was done


def reset_launches():
    launches.clear()


def _nvcc():
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def _stale(name):
    so = os.path.join(_BUILD, f"lib{name}.so")
    if not os.path.exists(so):
        return True
    deps = [os.path.join(_CSRC, f"{name}.cu")] + [
        os.path.join(_CSRC, h) for h in os.listdir(_CSRC) if h.endswith(".cuh")]
    return any(os.path.getmtime(so) < os.path.getmtime(d) for d in deps)


def build():
    """Compile every stale source, one nvcc each, all in parallel.

    Returns the wall seconds spent; raises RuntimeError with the compiler's
    output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = os.path.join(_BUILD, f"lib{name}.so.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate(timeout=600)
        build_log[name] = out
        build_secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, os.path.join(_BUILD, f"lib{name}.so"))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name):
    """The loaded library of csrc/<name>.cu, building it at first use."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name not in _libs:
            build()
            so = ctypes.CDLL(os.path.join(_BUILD, f"lib{name}.so"))
            for entry in _ENTRY_POINTS.get(name, (name,)):
                fn = getattr(so, entry)
                fn.argtypes = _ARGTYPES[entry]
                fn.restype = ctypes.c_int
            _libs[name] = so
    return _libs[name]


def check(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def stream_ptr(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr_array(tensors):
    arr = (ctypes.c_void_p * MAXCH)()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def require_cuda(name, tensors, word=4):
    """Check that every tensor is a contiguous tensor of `word`-byte
    elements (any size with word=None) on one CUDA device (permutations,
    gathers and scans move 32-bit words)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if word is not None and t.element_size() != word:
            raise TypeError(f"{name}: tensors must hold {8 * word}-bit words; "
                            f"got {t.dtype}")


def k1_code(mult, x_dt, y_dt, z_dt):
    """(code, fast) of K1's multiply z = mult(x, y) for x of x_dt and y of
    y_dt, its product cast to the monoid's z_dt (gather_mult.cu mult_dyn),
    or None where K1 does not take it: a multiply that is not a builtin
    of the table (a user function, a numpy ufunc, the JAX package's
    Python binaries, a positional op), or a type of more than 32 bits."""
    from ..operator.binary import BUILTINS

    types = (x_dt, y_dt, mult.type, mult.type2, mult.return_type, z_dt)
    if (BUILTINS.get(mult.name) is not mult.parent or mult.name not in K1_OP
            or any(t.name not in K1_TYPE for t in types)):
        return None
    x, y, t1, t2, rt, z = (K1_TYPE[t.name] for t in types)
    code = (x | y << 3 | t1 << 6 | t2 << 9 | rt << 12 | z << 15
            | K1_OP[mult.name] << 18)
    same = len({t.name for t in types}) == 1
    return code, K1_FAST.get((mult.name, mult.type.name), 0) if same else 0
