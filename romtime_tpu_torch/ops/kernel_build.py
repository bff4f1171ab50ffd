"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. A library is keyed by the
hash of its source, the shared ``csrc/*.cuh`` headers and the flags, and
lives in :func:`build_dir`; a library already built from the same inputs
is reused. Nothing is built when the package is imported: the first
launch builds, and :func:`build_all` starts one nvcc per source, all at
once (what ``chip_smoke.py`` does first).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}


def build_dir():
    """Kernel build directory (listed in .gitignore): ``build/kernels``
    at the root of the checkout, or ``ROMTIME_TORCH_BUILD_DIR``."""
    env = os.environ.get("ROMTIME_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def sources():
    """Every kernel source of the package."""
    return sorted(CSRC.glob("*.cu"))


def _library_path(source):
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(srcs=None):
    """Compile ``srcs`` (default: every source) in parallel, one nvcc
    each; returns {source: (library path, seconds, compiler log)}: each
    nvcc's own wall seconds, 0 for a library that was already built.
    Raises if any build fails."""
    srcs = [Path(s) for s in (sources() if srcs is None else srcs)]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    results, running = {}, []
    for src in srcs:
        lib = _library_path(src)
        if lib.exists():
            log = lib.with_suffix(".log")
            results[src] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc, time.perf_counter()))

    def finish(proc, t0):
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(running))) as pool:
        done = [pool.submit(finish, proc, t0)
                for _s, _l, _t, proc, t0 in running]
    failed = []
    for (src, lib, tmp, proc, _t0), fut in zip(running, done):
        log, seconds = fut.result()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        results[src] = (lib, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def ptxas_report(log):
    """Each compiled kernel of an nvcc log (``-Xptxas -v``): a list of
    {"function", "registers", "stack", "spill_stores", "spill_loads"},
    in the log's order (the mangled name carries the template
    arguments)."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"function": m.group(1)}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return rows


def load(name, bind):
    """The ctypes library of ``csrc/<name>.cu``, built on first use;
    ``bind(lib)`` declares its entry points' argtypes and restype."""
    lib = _LIBS.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        path = build_all([src])[src][0]
        lib = ctypes.CDLL(str(path))
        lib.romtime_cuda_error_string.argtypes = [ctypes.c_int]
        lib.romtime_cuda_error_string.restype = ctypes.c_char_p
        bind(lib)
        _LIBS[name] = lib
    return lib


def check_launch(lib, err, what):
    """Raise with the CUDA error string if a launch returned non-zero."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.romtime_cuda_error_string(err).decode())


def device_route(t):
    """"cpu" (a wrapper runs its twin) or "cuda" (it launches its kernel);
    raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def launch(name, bind, entry, label, tensors, ints, dt, out_shapes,
           extra=()):
    """Check the operands (float32, contiguous, on one device), allocate
    float32 outputs of ``out_shapes`` and launch ``entry`` of the library
    of ``csrc/<name>.cu`` on the current stream with (operand pointers,
    output pointers, ``extra`` pointers (a tensor or None each: the phase
    clocks' int64 buffer), ``ints``, ``dt``, stream). Returns the
    outputs."""
    device = tensors[0][1].device
    for arg, t in tensors:
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{arg} must be float32 on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    lib = load(name, bind)
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in out_shapes]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *[t.data_ptr() for _arg, t in tensors],
            *[o.data_ptr() for o in outs],
            *[None if e is None else e.data_ptr() for e in extra], *ints,
            float(dt), stream)
    check_launch(lib, err, label)
    return tuple(outs)
