"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``marlin_tpu_torch/csrc/`` is a self-contained
``.cu`` file with a plain C entry point (no PyTorch headers), compiled by
``nvcc`` for Hopper into a shared library and bound with :mod:`ctypes`.
Building happens at first use, never at import: the CPU tests import
every module of the package on a machine with no ``nvcc``.

Libraries land in ``marlin_tpu_torch/_build/`` (git-ignored), named by a
hash of their source, every shared header (``csrc/*.cuh``, which the
sources include through ``-I csrc``) and the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as is. :func:`build`
starts one ``nvcc`` per missing source, all at once, and waits for them
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# Every kernel source of the port, by library name.
SOURCES = {"flash_attention_fwd": CSRC_DIR / "flash_attention_fwd.cu",
           "flash_attention_bwd": CSRC_DIR / "flash_attention_bwd.cu",
           "flash_attention_wide": CSRC_DIR / "flash_attention_wide.cu",
           "block_sparse": CSRC_DIR / "block_sparse.cu"}

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source on the machine with the GPU")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(source, out, ptxas_verbose: bool = False,
                 include=None) -> list:
    """The nvcc command line that builds ``source`` into the shared
    library ``out``, with ``include`` (default ``csrc/``) on the include
    path."""
    return [find_nvcc(), *NVCC_FLAGS, "-I", str(include or CSRC_DIR),
            *(["-Xptxas=-v"] if ptxas_verbose else []), "-o", str(out),
            str(source)]


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every source in ``names`` (default: all) whose library is
    missing, one ``nvcc`` process per source, all started together.
    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0.0 and
    ``log`` empty for a library that was already built. Raises with the
    compiler's output when any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            nvcc_command(SOURCES[name], tmp, ptxas_verbose),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees half a file
        out[name] = {"path": str(path), "seconds": secs, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built first if
    needed. Thread-safe: tensor-parallel shards (models/tp.py) launch
    from threads of their own, and one build serves them all."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            # One build serves every shard's thread: the others wait.
            path = build([name])[name]["path"]  # marlint: allow-blocking=once
            lib = _loaded[name] = ctypes.CDLL(path)
    return lib
