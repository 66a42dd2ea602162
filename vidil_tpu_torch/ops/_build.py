"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``vidil_tpu_torch/csrc/`` is compiled on first use into
its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source and of every header under
``csrc/`` that it includes (``#include "..."``, followed recursively), so an
edited source or header is rebuilt and an unchanged one is reused within a
checkout. The build
directory (``vidil_tpu_torch/_build/``) is listed in ``.gitignore``;
``ptxas``'s register and shared-memory report is kept beside each library
as ``<lib>.log``. `build_all` starts one nvcc per source at once.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# kernel library name -> its source under csrc/
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "fused_mlp_fwd": "fused_mlp_fwd.cu",
    "fused_vit_block_fwd": "fused_vit_block_fwd.cu",
    "fused_vit_block_bwd": "fused_vit_block_bwd.cu",
    "decode_cross_attention": "decode_cross_attention.cu",
    "grouped_expert_gemm": "grouped_expert_gemm.cu",
}

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels "
                           "are built from vidil_tpu_torch/csrc/ at first use")
    return found


def source_files(name: str) -> list[Path]:
    """The source of kernel library `name` and every file under csrc/ that
    it includes, directly or through another header, in include order."""
    files, todo = [], [CSRC_DIR / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every missing kernel library, one nvcc per source, all
    started together. Returns {name: library path}; raises with nvcc's
    output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        jobs[name] = (lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (lib, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        Path(f"{lib}.log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
