"""Build the CUDA kernels in ``lxt_tpu_torch/csrc`` at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object (in parallel), and the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The library lands in
``lxt_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the last build.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib = None
#: seconds the last call to :func:`library` spent compiling (0 when reused)
build_seconds = 0.0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return str(path)


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, target):
    """nvcc each source to an object in parallel, then link ``target``;
    the compiler's output goes to ``<target>.log``."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    log = []
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = tmp / target.name
        cmd = [nvcc, "-shared", "-o", str(so)] + [str(o) for _, o, _ in procs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        os.replace(so, target)
    finally:
        target.with_suffix(".log").write_text("\n".join(log))
        shutil.rmtree(tmp, ignore_errors=True)


def _target():
    return BUILD_DIR / f"liblxt_kernels-{_digest()}.so"


def log_path():
    """The nvcc log (with ptxas's registers and spills of every kernel) of
    the library that :func:`library` loads."""
    return _target().with_suffix(".log")


def library():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib, build_seconds
    if _lib is None:
        sources = sorted(SRC_DIR.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = _target()
        if not target.exists():
            t0 = time.perf_counter()
            _compile(sources, target)
            build_seconds = time.perf_counter() - t0
        _lib = ctypes.CDLL(str(target))
    return _lib
