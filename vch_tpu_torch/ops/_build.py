"""Build and load the CUDA kernels of the port.

`nvcc` compiles each of `vch_tpu_torch/csrc/*.cu` for sm_90a once per
members-per-CTA instantiation (`-DVCH_BB=1` and `8`: one member per CTA,
and the block that `resolved_fused_block()` picks), all at once in
parallel, and links the objects into one shared library with a plain C
interface, at first use, into `vch_tpu_torch/_build/` (listed in
.gitignore); `ctypes` loads it. The library's file name carries a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing here runs at import: `load()` is called by the kernel
wrappers on their first CUDA launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("march2d.cu", "adjoint2d.cu")
MEMBER_BLOCKS = (1, 8)   # the VCH_BB objects of each source
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds = None     # wall seconds of the last nvcc run (None: reused)
ptxas_log = ""           # nvcc/ptxas output of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(MEMBER_BLOCKS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library of the current sources exists;
    return its path."""
    global build_seconds, ptxas_log
    out = BUILD_DIR / f"libvch_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = [(src, bb, os.path.join(tmpdir, f"{Path(src).stem}_{bb}.o"))
                for src in SOURCES for bb in MEMBER_BLOCKS]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-DVCH_BB={bb}", "-c",
                                   "-o", obj, str(SRC_DIR / src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, bb, obj in jobs]
        logs = [p.communicate()[0] for p in procs]
        ptxas_log = "".join(f"[{src} VCH_BB={bb}]\n{log}"
                            for (src, bb, _), log in zip(jobs, logs))
        failed = [f"{src} VCH_BB={bb}: nvcc exit {p.returncode}"
                  for (src, bb, _), p in zip(jobs, procs)
                  if p.returncode != 0]
        objs = [obj for _, _, obj in jobs]
        if not failed:
            lib = os.path.join(tmpdir, out.name)
            link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True)
            ptxas_log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append(f"link: nvcc exit {link.returncode}")
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("; ".join(failed) + ":\n" + ptxas_log)
        os.replace(lib, out)   # atomic: a concurrent build never loads a stub
    return out


def load():
    """The loaded kernel library, with every function's argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.vch_workspace_fields.argtypes = [_I]
    lib.vch_workspace_fields.restype = _I
    # dts phi0 u Lx LyT Vxi VyiT Vx VyT lam wts | hist nsolve bad work |
    # B M n m | consts nconst | max_iter n_trips stagnation block_b | stream
    lib.vch_march_fused_2d.argtypes = ([_P] * 11 + [_P] * 4 + [_I] * 4
                                       + [_FP, _I] + [_I] * 4 + [_P])
    # dts phi0 mu0 w0 m0 u Lx LyT Vxi VyiT Vx VyT lam wts | hist phi_f mu_f
    # w_f nsolve bad work | B K n m | consts nconst | max_iter n_trips
    # stagnation | stream
    lib.vch_march_fused_2d_segment.argtypes = ([_P] * 14 + [_P] * 7
                                               + [_I] * 4 + [_FP, _I]
                                               + [_I] * 3 + [_P])
    # dts hist phiQ phiT b1 b2 Lx LyT Vxi VyiT Vx VyT lam | r work |
    # B M n m | consts nconst | n_trips block_b | stream
    lib.vch_adjoint_fused_2d.argtypes = ([_P] * 13 + [_P] * 2 + [_I] * 4
                                         + [_FP, _I] + [_I] * 2 + [_P])
    # dts hist phiQ p0 q0 r0 b1 Lx LyT Vxi VyiT Vx VyT lam | r p_f q_f r_f
    # work | B K n m | consts nconst | n_trips | stream
    lib.vch_adjoint_fused_2d_segment.argtypes = ([_P] * 14 + [_P] * 5
                                                 + [_I] * 4 + [_FP, _I]
                                                 + [_I] + [_P])
    for fn in (lib.vch_march_fused_2d, lib.vch_march_fused_2d_segment,
               lib.vch_adjoint_fused_2d, lib.vch_adjoint_fused_2d_segment):
        fn.restype = _I
    lib.vch_error_string.argtypes = [_I]
    lib.vch_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
