"""Build the package's CUDA kernels with ``nvcc`` and load them via ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
that take device pointers and a stream) and compiles on its own into
``_build/lib<name>-<hash>.so`` for ``sm_90a``; the hash of the source
(and of the headers of ``csrc/`` that it includes) names the library, so
an edited source is rebuilt and an unchanged one is reused.  Building
happens at first use, never at import: the CPU-only test environment has
no ``nvcc``.

Every kernel wrapper counts its launches here (``count_launch``), so a
run can show that its main path went through the hand-written kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# every kernel source of the package (csrc/<name>.cu)
KERNELS = ("knn_exact", "ivf_score", "banded_spmm", "kmeans_assign",
           "gather_spmm")

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHES: dict[str, int] = {}
# nvcc seconds of every kernel compiled by this process
_BUILD_SECONDS: dict[str, float] = {}


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict:
    """Launches per kernel since the last ``reset_launch_counts``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _cuda_tool(tool: str):
    """Path of a CUDA toolkit program (PATH, then $CUDA_HOME/bin), or
    None."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / tool
    return str(cand) if cand.exists() else None


def _nvcc() -> str:
    found = _cuda_tool("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels of cna_tpu_torch are compiled at first use and "
            "need the CUDA toolkit")
    return found


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes with
    quotes, directly or through another such header."""
    found, queue = [], [CSRC / f"{name}.cu"]
    while queue:
        path = queue.pop(0)
        if path in found:
            continue
        found.append(path)
        queue += [CSRC / inc.decode()
                  for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return found


def _target(name: str) -> Path:
    parts = [p.read_bytes() for p in _sources(name)]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) for ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_count(name: str, opcode: str) -> int:
    """How many SASS lines of the built library of ``name`` carry
    ``opcode`` (``cuobjdump -sass``; e.g. "HMMA", the tensor-core opcode
    behind ``mma.sync``).  Raises RuntimeError where the
    toolkit has no ``cuobjdump``."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin)")
    build(name)
    res = subprocess.run([tool, "-sass", str(_target(name))],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}:\n{res.stdout}")
    return sum(1 for line in res.stdout.splitlines()
               if f" {opcode}" in line and "/*" in line)


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is built already;
    return the seconds spent (0.0 when it was there).  Raises
    RuntimeError with nvcc's output if the build fails."""
    out = _target(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(res.stdout)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{res.returncode}\n{res.stdout}")
    os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    _BUILD_SECONDS[name] = seconds
    return seconds


def build_seconds() -> dict:
    """``{name: nvcc seconds}`` of the kernels this process compiled (a
    kernel found built already is not listed)."""
    return dict(_BUILD_SECONDS)


def build_all(names=KERNELS) -> dict:
    """Compile several kernels at once, one ``nvcc`` process per source,
    all started together; returns ``{name: seconds}``.  Raises the first
    build error."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib
