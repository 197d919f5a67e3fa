"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``.cu`` file has a plain C interface and becomes its own shared
library: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``,
one ``nvcc`` per source, all started together.  Libraries are keyed by
a hash of their source, every ``csrc`` header it includes (``#include
"..."``, followed recursively) and the flags, and land in
``build/repro_torch_kernels/`` at the root of the checkout (ignored by
git), so a rebuilt checkout and an edited kernel or header all rebuild,
and nothing stale is ever loaded.  They are loaded with ``ctypes``;
every pointer and the stream pass as ``c_void_p`` (a bare int would be
cut to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source stem -> {C entry point: argtypes}
ENTRY_POINTS = {
    "pe_conv_grad": {
        "repro_pe_conv_grad_2d": [_P, _P, _P] + [_I] * 11 + [_P],
        "repro_pe_conv_grad_1d": [_P, _P, _P] + [_I] * 7 + [_P]},
    "gram_norm": {
        "repro_gram_norm": ([_P] + [_L] * 3) * 2 + [_P] * 4 + [_I] * 13
                           + [_P],
        "repro_gram_norm_fused": ([_P] + [_L] * 3) * 2 + [_P] * 7
                                 + [_I] * 11 + [_P],
        "repro_gram_norm_tokmask": [_P] * 5 + [_I] * 6 + [_P]},
    "flash_attn": {
        "repro_flash_fwd": ([_P] + [_L] * 3) * 3 + [_P] * 2 + [_I] * 8
                           + [_P],
        "repro_flash_bwd": [_I] + ([_P] + [_L] * 3) * 4 + [_P] * 5
                           + [_I] * 8 + [_P],
        "repro_flash_design": [_I] * 3,
        "repro_flash_fma_only": [_I]},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(stem: str) -> list[pathlib.Path]:
    """``csrc/<stem>.cu`` and every header it includes with quotes,
    recursively, in first-seen order."""
    seen, todo = [], [CSRC / f"{stem}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in sources(stem):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns {"seconds": wall time, "built": [...], "ptxas": {stem: log}}."""
    t0 = time.perf_counter()
    todo = {s: _lib_path(s) for s in ENTRY_POINTS if not _lib_path(s).exists()}
    logs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for stem, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[stem] = log
            if proc.returncode != 0:
                failed.append(
                    f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(todo),
            "ptxas": logs}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in ENTRY_POINTS[stem].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[stem] = lib
    return lib
