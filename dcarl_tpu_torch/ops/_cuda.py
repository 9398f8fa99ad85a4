"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes one plain C entry point ``<name>`` and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes``.  Builds happen at first use, from the
sources in the package, into ``build/torch_kernels/`` beside the
package (git-ignored); a library's file name carries a hash of its
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source builds anew and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing library, all
at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags a library adds to those: ``peraction_moments`` instantiates its
# main pass for every number of actions (32 kernels), which nvcc then
# optimises on all cores (the same SASS, in half the time on an 8-core host).
EXTRA_FLAGS: Dict[str, Sequence[str]] = {
    "peraction_moments": ("--split-compile=0",),
}

# Source name -> ctypes argument types of its C entry point.  Every
# device pointer and the stream are c_void_p (a plain c_int would cut a
# 64-bit pointer).  A store kernel's last arguments are the counters'
# device totals (None: the launch counts nothing; ``utils/profiling``),
# the stream and a host int that receives the main pass's block count;
# ``capture_nodes`` (no kernel: the node count of a capturing graph,
# for the phase tables of ``utils/profiling``) takes a stream and a host
# count.  Each entry point returns a cudaError_t as an int.
_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
SIGNATURES: Dict[str, Sequence] = {
    "peraction_moments": (_P,) * 16 + (_I,) * 6 + (_P,) * 5 + (_IP,),
    "sorted_moments": (_P,) * 7 + (_I,) * 5 + (_P,) * 4 + (_IP,),
    "box_moments": (_P,) * 7 + (_I,) * 4 + (_P,) * 4 + (_IP,),
    "capture_nodes": (_P, ctypes.POINTER(ctypes.c_ulonglong)),
}

# Launches per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels it went
# through.  Zero it with ``LAUNCHES.clear()``.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

# Blocks in the persistent main pass of each kernel's latest launch (the
# occupancy on this device times its SMs).
GRID: Dict[str, int] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _flags(name: str) -> Sequence[str]:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def lib_path(name: str) -> Path:
    # the source and every shared header it may include
    src = b"".join(p.read_bytes() for p in
                   [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))])
    flags = " ".join(_flags(name)).encode()
    tag = hashlib.sha256(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns name -> the compiler's
    resource report (``-Xptxas -v``) for the kernels it built.  Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *_flags(name), "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib

