"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ``ctypes``.  Libraries go to ``raftstereo_tpu_torch/build/`` (git
ignored), named by a hash of the source, every ``csrc/*.cuh`` header and
the flags, so an edited source or header rebuilds and an unchanged one is
reused.  The first ``load`` builds every source at once, one ``nvcc``
process per file, all started together.  Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded_by: _lock


def sources() -> Dict[str, Path]:
    """Kernel name -> source file."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def headers() -> List[Path]:
    """The headers the sources may include, in name order."""
    return sorted(CSRC.glob("*.cuh"))


def source_text(name: str) -> str:
    """Kernel ``name``'s source with the text of each local header it
    includes (``#include "x.cuh"``) after it."""
    text = sources()[name].read_text()
    for inc in re.findall(r'^#include "([^"]+)"', text, re.M):
        text += "\n" + (CSRC / inc).read_text()
    return text


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes())
    for hdr in headers():  # any header may be included: hash them all
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    name -> library path.  Raises ``RuntimeError`` with the compiler's
    output if any build fails.  The compiler's report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(src) for name, src in sources().items()}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees whole files
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if it is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib
