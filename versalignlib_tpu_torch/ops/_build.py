"""Build the hand-written CUDA kernels of ``csrc/`` and bind them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C entry that launches its kernel on
the stream it is given and returns ``cudaGetLastError()``. ``nvcc`` compiles
each source at first use into ``build/`` (listed in ``.gitignore``), under a
name that carries a digest of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Several sources build in
parallel, one ``nvcc`` each.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

from versalignlib_tpu_torch.utils.logging import get_logger

_log = get_logger("build")

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Where the CUDA toolkit puts nvcc when it is not on PATH.
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(f"nvcc not found (neither on PATH nor at {DEFAULT_NVCC}): "
                       "the CUDA kernels cannot be built")


def library_path(source: str) -> pathlib.Path:
    """Where ``csrc/<source>`` is built: ``build/<stem>-<digest>.so``. The
    digest covers the source, the headers of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, float]:
    """Compile every source in ``sources`` that is not built yet, all at
    once. Returns the seconds each compile took (0.0 when it was built
    already). The compiler's report (registers, spills) is kept beside each
    library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    seconds = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            seconds[source] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, out, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for source, out, tmp, cmd, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        _log.info("nvcc %s: rc %d in %.1f s", source, proc.returncode, seconds[source])
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        # Rename into place, so that processes building at the same time
        # never load a half-written library.
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_all() -> dict[str, float]:
    """Build every kernel source of the package (see :func:`build`)."""
    return build(sorted(p.name for p in CSRC.glob("*.cu")))


class CudaKernel:
    """One C launch entry of a ``csrc/*.cu`` source, built at first use.

    ``launches`` counts the launches made through :meth:`launch`, and
    nothing else, so that a run can show which kernels its path reached
    (under a lock: a mesh launches from one thread a card).
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._fn = None

    def _function(self):
        with _lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib, self._fn = lib, fn
        return self._fn

    def call(self, *args) -> None:
        """Call the entry, counting no launch (a query such as an
        occupancy); raises if it returned a CUDA error."""
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} ({self.source}) failed: CUDA error {rc}")

    def launch(self, *args) -> None:
        """Launch the kernel; raises if CUDA refused the launch."""
        self.call(*args)
        with self._count_lock:
            self.launches += 1
