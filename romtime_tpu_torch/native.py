"""ctypes loader of the port's native host kernels
(``csrc/host/romtime_native.cpp``, ``csrc/host/fom_piston.cpp``;
counterpart of ``romtime_tpu/native.py``).

The library is built with the host compiler at its first use,
``g++ -O3 -shared -fPIC -std=c++17``, into ``build/native/`` at the root
of the checkout (listed in ``.gitignore``), and rebuilt at a process's
first load when a source is newer than it. A failed build raises with g++'s log: the sandbox and the
card's machine both have a host compiler, so no consumer falls back
quietly. ``calls`` counts each entry's calls (the card run checks that
the f64 FOM solves went through the native loop).
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCES = (
    Path(__file__).resolve().parent / "csrc" / "host" / "romtime_native.cpp",
    Path(__file__).resolve().parent / "csrc" / "host" / "fom_piston.cpp",
)
BUILD_DIR = _ROOT / "build" / "native"
LIBRARY = BUILD_DIR / "libromtime_native.so"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

#: Calls of each entry since import (or since the caller reset them).
calls = {"deim_greedy": 0, "thomas_solve": 0, "piston_fom_solve": 0}

_LOCK = threading.Lock()
_LIB = None

_DPTR = ctypes.POINTER(ctypes.c_double)
_IPTR = ctypes.POINTER(ctypes.c_int64)


def _stale():
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES)


def build():
    """Compile the library into :data:`LIBRARY` unless it is up to date
    (under a file lock, so parallel processes build it once); returns
    its path. Raises ``RuntimeError`` with the compiler's log if g++
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as err:
                os.unlink(tmp)
                raise RuntimeError(
                    f"native build failed: {' '.join(cmd)}: {err}") from err
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"native build failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, LIBRARY)
    return LIBRARY


def load():
    """The loaded library, built at the first load where needed; later
    calls return the same library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.deim_greedy.restype = ctypes.c_int
            lib.deim_greedy.argtypes = [_DPTR, ctypes.c_int64, ctypes.c_int64,
                                        _IPTR, ctypes.c_int64, _IPTR]
            lib.thomas_solve.restype = ctypes.c_int
            lib.thomas_solve.argtypes = [_DPTR] * 4 + [ctypes.c_int64, _DPTR]
            lib.piston_fom_solve.restype = ctypes.c_int
            lib.piston_fom_solve.argtypes = [
                ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double,                      # L0, nx, nt, dt
                ctypes.c_double, ctypes.c_double,
                ctypes.c_double,                      # a0, alpha, b0
                _DPTR, _DPTR, _DPTR, _DPTR,           # s, r, bL, dbL
                _DPTR,                                # u0
                _IPTR, _IPTR, ctypes.c_int64,         # nl rows, cols, n
                _DPTR, _DPTR,                         # uh_out, nl_out
            ]
            _LIB = lib
        return _LIB


def _f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _i64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def deim_greedy(Vf, forbidden=()):
    """The greedy DEIM dofs of the basis ``Vf`` (nh, ns), the positions
    in ``forbidden`` masked out, with ``deim.deim``'s tie rule. Raises
    ``numpy.linalg.LinAlgError`` on a singular interpolation system and
    ``ValueError`` where every position is forbidden."""
    lib = load()
    Vf = _f64(Vf)
    nh, ns = Vf.shape
    forbidden = _i64(list(forbidden))
    out = np.zeros(ns, dtype=np.int64)
    calls["deim_greedy"] += 1
    status = lib.deim_greedy(
        Vf.ctypes.data_as(_DPTR), nh, ns, forbidden.ctypes.data_as(_IPTR),
        len(forbidden), out.ctypes.data_as(_IPTR))
    if status == 1:
        raise np.linalg.LinAlgError("DEIM greedy: singular interpolation "
                                    "system")
    if status != 0:
        raise ValueError("DEIM greedy: no admissible position")
    return [int(d) for d in out]


def thomas_solve(lower, diag, upper, rhs):
    """One tridiagonal system by the Thomas recursion (float64); raises
    ``ZeroDivisionError`` on a zero pivot."""
    lib = load()
    arrays = [_f64(a) for a in (lower, diag, upper, rhs)]
    n = arrays[0].shape[0]
    x = np.zeros(n, dtype=np.float64)
    calls["thomas_solve"] += 1
    status = lib.thomas_solve(*(a.ctypes.data_as(_DPTR) for a in arrays), n,
                              x.ctypes.data_as(_DPTR))
    if status != 0:
        raise ZeroDivisionError("Thomas solve: zero pivot")
    return x


def piston_fom_solve(L0, nx, nt, dt, a0, alpha, b0, s, r, bL, dbL, u0,
                     nl_rows, nl_cols):
    """The piston FOM time loop (``fom_piston.cpp``) in float64: returns
    (uh (nt, nh), nl (nt, n_nl)), the homogeneous trajectory and the
    gathered trilinear snapshot rows. ``s``, ``r``, ``bL``, ``dbL`` are
    the per-step scalars (nt,) the caller evaluates from the problem's
    callables."""
    lib = load()
    s, r, bL, dbL, u0 = map(_f64, (s, r, bL, dbL, u0))
    nl_rows, nl_cols = _i64(nl_rows), _i64(nl_cols)
    nh = int(nx) + 1
    n_nl = len(nl_rows)
    uh = np.zeros((int(nt), nh), dtype=np.float64)
    nl = np.zeros((int(nt), max(n_nl, 1)), dtype=np.float64)
    calls["piston_fom_solve"] += 1
    status = lib.piston_fom_solve(
        float(L0), int(nx), int(nt), float(dt), float(a0), float(alpha),
        float(b0), *(a.ctypes.data_as(_DPTR) for a in (s, r, bL, dbL, u0)),
        nl_rows.ctypes.data_as(_IPTR), nl_cols.ctypes.data_as(_IPTR), n_nl,
        uh.ctypes.data_as(_DPTR), nl.ctypes.data_as(_DPTR))
    if status != 0:
        raise RuntimeError(f"piston_fom_solve returned {status}")
    return uh, nl[:, :n_nl]
