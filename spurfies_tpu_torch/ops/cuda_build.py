"""Build and load the port's CUDA kernels (``csrc/*.cu``) and its host
routines (``csrc/*.cpp``).

Each CUDA source is compiled by ``nvcc`` for ``sm_90a``, each host source by
the host's C++ compiler, into a shared library with a plain C interface,
loaded with ``ctypes``.  Libraries go to
``spurfies_tpu_torch/build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and a current one is reused.  :func:`build` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("select_knn", "sdf_agg", "agg_bwd", "scatter_rows", "color_mlp",
           "gather_rows")
HOST_SOURCES = ("host_dedup", "host_jpeg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# IEEE order as written: no FMA contraction
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")

_LIBS: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's standard location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def host_compiler() -> str:
    """``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++)")
    return cxx


def _host(name: str) -> bool:
    return name in HOST_SOURCES


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.{'cpp' if _host(name) else 'cu'}"


def lib_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    flags = HOST_FLAGS if _host(name) else NVCC_FLAGS
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES + HOST_SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    compiler process per source (``nvcc`` for a ``.cu``, the host's for a
    ``.cpp``), all started together.

    Returns ``{name: seconds}`` (0.0 for a library that was already built).
    Raises ``RuntimeError`` with the compiler's output if a build fails.
    The compiler's register and shared-memory report (``-Xptxas -v``) is
    kept in ``build/<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if _host(name):
            cmd = [host_compiler(), *HOST_FLAGS]
        else:
            cmd = [nvcc_path(), *NVCC_FLAGS]
        cmd += ["-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"building {source_path(name).name} failed "
                          f"({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def ptxas_report(log: str) -> dict:
    """``{entry function: [its lines]}`` from the ``-Xptxas -v`` output of
    one build (``build/<name>.log``): the register and spill lines that
    follow each entry's "Compiling entry function", and the notes that name
    it ("... in function '<name>'", such as a ``wgmma`` serialised for its
    registers)."""
    report, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        named = re.search(r"in function '([^']+)'", line)
        if m:
            entry = m.group(1)
            report.setdefault(entry, [])
        elif named:
            report.setdefault(named.group(1), []).append(line.strip())
        elif entry is not None and ("spill" in line or "Used" in line):
            report[entry].append(line.strip())
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library ``name``, built if needed, with ``argtypes`` set from
    ``signatures`` (``{function: [ctypes types]}``, each returning int)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
