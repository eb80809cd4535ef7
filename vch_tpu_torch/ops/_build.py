"""Build and load the CUDA kernels of the port, and the checks every
kernel wrapper makes before a launch.

`nvcc` compiles each source of `vch_tpu_torch/csrc/` for sm_90a once per
object listed in `SOURCES`, each object with its own flags: the cluster
march with `-DVCH_BB=8`, `4`, `2` (members per thread-block cluster of the
member-blocked march), `1` (the whole one-member march) and `1` with
`-DVCH_SEG=1` (the segment march), each of the five once more with
`-DVCH_PREC=1` (the same march with its Krylov operator's products on bf16
mma.sync, `fused_solve_precision` "bf16x3" or "default") and once more with
`-DVCH_PREC=2` (every product of the march on bf16 mma.sync, `fwd_mm`
"bf16x3"), and the cluster sweep with `-DVCH_BB=8`,
`4`, `2` (the member-blocked sweep), `1` (the whole one-member sweep) and
`1` with `-DVCH_SEG=1` (the segment sweep), each of the five once more with
`-DVCH_PREC=1` (its Krylov operator's products on bf16 mma.sync,
`adjoint_solve_precision` "bf16x3"), one kernel per object; the
one-CTA per-solve kernels five times, the spectral and the raw Schur solve
and the spectral adjoint solve (`-DVCH_VARIANT=0`, `1`, `2`: three cluster
solves' bit oracles) each apart, the two cost probes (`-DVCH_VARIANT=4`:
the cluster probes' oracles) together, and the raw adjoint solve (the
object without a variant); the cluster solves five times
(`-DVCH_VARIANT=0`, `1`, `2`, `3`: the spectral and the raw Schur solve,
the spectral and the raw adjoint step solve; `4`: the two cost probes on
the raw Schur solve's operators); the one-CTA 2D march and
sweep (the bit oracles of the cluster march and sweep), the operator
applies, the fused 1D march, the cost probes of probes.cu (one CTA per
block of members; its chains and its microbench are the bit oracles of
the chain probes and of the cluster microbench) and the chain probes of
chain_cluster.cu and the cluster microbench of micro_cluster.cu, each of
the last three holding its own members-per-block templates, and the while
probe of while_fused.cu (phi in registers; probes.cu's while kernel is its
bit oracle), once each. 43 objects in all. The 1D march, both sweeps, both Schur and the
spectral adjoint cluster solves, the cluster probes and their oracles
compile with `-fmad=false`: their only FMAs are the explicit ones of their
products, so that no copy of an elementwise expression that the compiler
unrolls rounds differently from another, and each cluster kernel rounds
as its one-CTA oracle does (the raw Schur operator's (tau/dt + d) v -
(kappa/2) L v and the iterate update x + alpha ph + omega sh add two
products, which two codes could fuse apart). The raw adjoint cluster solve
and its oracle (variant 3, in the first object) compile with nvcc's
default contraction: no expression of theirs adds two products, so nvcc
fuses them alike, and the contracted raw solve lies nearer float64 on
rough inputs. while_fused.cu compiles with probes.cu's flags, nvcc's
default contraction, so that its sums of squares fuse into the FMAs of its
oracle's. All objects compile at once in parallel, and link
into one shared library with a plain C interface, at first use, into
`vch_tpu_torch/_build/` (listed in .gitignore); `ctypes` loads it. The
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at
import: `load()` is called by the kernel wrappers on their first CUDA
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# each source and its objects, each object's own flags
SOURCES = {"march2d.cu": (("-DVCH_BB=1",),),
           "march2d_blocked.cu": tuple((f"-DVCH_BB={bb}",) + prec
                                       for prec in ((), ("-DVCH_PREC=1",),
                                                    ("-DVCH_PREC=2",))
                                       for bb in (8, 4, 2, 1))
           + (("-DVCH_BB=1", "-DVCH_SEG=1"),
              ("-DVCH_BB=1", "-DVCH_SEG=1", "-DVCH_PREC=1"),
              ("-DVCH_BB=1", "-DVCH_SEG=1", "-DVCH_PREC=2")),
           "adjoint2d.cu": (("-fmad=false",),),
           "adjoint2d_cluster.cu": tuple((f"-DVCH_BB={bb}",) + prec
                                         + ("-fmad=false",)
                                         for prec in ((), ("-DVCH_PREC=1",))
                                         for bb in (8, 4, 2, 1))
           + (("-DVCH_BB=1", "-DVCH_SEG=1", "-fmad=false"),
              ("-DVCH_BB=1", "-DVCH_SEG=1", "-DVCH_PREC=1", "-fmad=false")),
           "solve2d.cu": ((),) + tuple((f"-DVCH_VARIANT={v}", "-fmad=false")
                                       for v in (0, 1, 2, 4)),
           "solve2d_cluster.cu": tuple((f"-DVCH_VARIANT={v}", "-fmad=false")
                                       for v in (0, 1, 2))
           + (("-DVCH_VARIANT=3",), ("-DVCH_VARIANT=4", "-fmad=false")),
           "apply2d.cu": ((),),
           "march1d.cu": (("-fmad=false",),), "probes.cu": ((),),
           "chain_cluster.cu": ((),),
           "micro_cluster.cu": ((),),
           "while_fused.cu": ((),)}
HEADERS = ("common.cuh", "tile4.cuh", "cluster.cuh", "mma_bf16.cuh",
           "adjoint.cuh", "adjoint_solve.cuh", "schur_solve.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds = None     # wall seconds of the last nvcc run (None: reused)
object_seconds = {}      # of the last nvcc run: wall seconds per object
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
    h.update(repr(SOURCES).encode())
    for name in tuple(SOURCES) + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library of the current sources exists;
    return its path."""
    global build_seconds, object_seconds, ptxas_log
    out = BUILD_DIR / f"libvch_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        name = lambda src, flags: "_".join(
            (Path(src).stem,) + tuple(f.strip("-").replace("=", "")
                                      for f in flags)) + ".o"
        jobs = [(src, flags, os.path.join(tmpdir, name(src, flags)))
                for src, objects in SOURCES.items() for flags in objects]

        def compile_one(job):
            src, flags, obj = job
            t = time.perf_counter()
            p = subprocess.run([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj,
                                str(SRC_DIR / src)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            return p.returncode, p.stdout, time.perf_counter() - t

        with ThreadPoolExecutor(len(jobs)) as pool:   # all at once
            done = list(pool.map(compile_one, jobs))
        tag = lambda src, flags: " ".join((src,) + flags)
        object_seconds = {tag(src, flags): sec
                          for (src, flags, _), (_, _, sec) in zip(jobs, done)}
        ptxas_log = "".join(f"[{tag(src, flags)}]\n{log}"
                            for (src, flags, _), (_, log, _) in zip(jobs,
                                                                     done))
        failed = [f"{tag(src, flags)}: nvcc exit {rc}"
                  for (src, flags, _), (rc, _, _) in zip(jobs, done)
                  if rc != 0]
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
    # dts phi0 u Lx LyT Vxi VyiT Vx VyT lam wts | hist nsolve bad work |
    # B M n m | consts nconst | max_iter n_trips stagnation | cluster kc
    # smem_bytes | active | ops16 passes fwd | stream
    lib.vch_march_fused_2d_cluster.argtypes = ([_P] * 11 + [_P] * 4
                                               + [_I] * 4 + [_FP, _I]
                                               + [_I] * 3 + [_I] * 3
                                               + [_P, _P, _I, _I, _P])
    # the same with members before cluster and no active
    lib.vch_march_fused_2d_blocked.argtypes = ([_P] * 11 + [_P] * 4
                                               + [_I] * 4 + [_FP, _I]
                                               + [_I] * 3 + [_I] * 4
                                               + [_P, _I, _I, _P])
    # members segment n m cluster kc smem_bytes
    lib.vch_march_blocked_max_clusters.argtypes = [_I] * 7
    lib.vch_march_blocked_max_clusters.restype = _I
    lib.vch_march16_max_clusters.argtypes = [_I] * 7
    lib.vch_march16_max_clusters.restype = _I
    lib.vch_march16f_max_clusters.argtypes = [_I] * 7
    lib.vch_march16f_max_clusters.restype = _I
    # dts phi0 mu0 w0 m0 u Lx LyT Vxi VyiT Vx VyT lam wts | hist phi_f mu_f
    # w_f nsolve bad work | B K n m | consts nconst | max_iter n_trips
    # stagnation | stream
    lib.vch_march_fused_2d_segment.argtypes = ([_P] * 14 + [_P] * 7
                                               + [_I] * 4 + [_FP, _I]
                                               + [_I] * 3 + [_P])
    # the same | cluster kc smem_bytes | ops16 passes fwd | stream
    lib.vch_march_fused_2d_segment_cluster.argtypes = (
        [_P] * 14 + [_P] * 7 + [_I] * 4 + [_FP, _I] + [_I] * 3 + [_I] * 3
        + [_P, _I, _I, _P])
    # dts hist phiQ phiT b1 b2 Lx LyT Vxi VyiT Vx VyT lam | r work |
    # B M n m | consts nconst | n_trips | stream
    lib.vch_adjoint_fused_2d.argtypes = ([_P] * 13 + [_P] * 2 + [_I] * 4
                                         + [_FP, _I] + [_I] + [_P])
    # dts hist phiQ p0 q0 r0 b1 Lx LyT Vxi VyiT Vx VyT lam | r p_f q_f r_f
    # work | B K n m | consts nconst | n_trips | stream
    lib.vch_adjoint_fused_2d_segment.argtypes = ([_P] * 14 + [_P] * 5
                                                 + [_I] * 4 + [_FP, _I]
                                                 + [_I] + [_P])
    # dts hist phiQ phiT b1 b2 Lx LyT Vxi VyiT Vx VyT lam | r work |
    # B M n m | consts nconst | n_trips | members cluster kc smem_bytes |
    # ops16 passes | stream
    lib.vch_adjoint_fused_2d_blocked.argtypes = ([_P] * 13 + [_P] * 2
                                                 + [_I] * 4 + [_FP, _I]
                                                 + [_I] + [_I] * 4
                                                 + [_P, _I, _P])
    # the whole sweep's arguments | cluster kc smem_bytes | ops16 passes |
    # stream
    lib.vch_adjoint_fused_2d_cluster.argtypes = ([_P] * 13 + [_P] * 2
                                                 + [_I] * 4 + [_FP, _I]
                                                 + [_I] + [_I] * 3
                                                 + [_P, _I, _P])
    # the segment's arguments | cluster kc smem_bytes | ops16 passes |
    # stream
    lib.vch_adjoint_fused_2d_segment_cluster.argtypes = (
        [_P] * 14 + [_P] * 5 + [_I] * 4 + [_FP, _I] + [_I] + [_I] * 3
        + [_P, _I, _P])
    # members segment n m cluster kc smem_bytes
    lib.vch_adjoint_cluster_max_clusters.argtypes = [_I] * 7
    lib.vch_adjoint_cluster_max_clusters.restype = _I
    lib.vch_adjoint16_max_clusters.argtypes = [_I] * 7
    lib.vch_adjoint16_max_clusters.restype = _I
    # variant scal Lx LyT Vxi VyiT Vx VyT lam f1 f2 rhs x0 | out work |
    # B n m n_iter floor_fac | stream
    lib.vch_bicgstab_2d.argtypes = ([_I] + [_P] * 12 + [_P] * 2 + [_I] * 4
                                    + [ctypes.c_float, _P])
    lib.vch_solve_workspace_fields.argtypes = []
    lib.vch_solve_workspace_fields.restype = _I
    # Vxi VyiT Vx VyT lam isd fpp rhs x0 tau_p half_dt_p | tau half_dt |
    # out work | B n m n_iter | floor_fac | cluster kc smem_bytes | stream
    lib.vch_bicgstab_adjoint_spectral_cluster.argtypes = (
        [_P] * 11 + [ctypes.c_float] * 2 + [_P] * 2 + [_I] * 4
        + [ctypes.c_float] + [_I] * 3 + [_P])
    # Lx LyT Vxi VyiT Vx VyT isd fpp rhs x0 tau_p half_dt_p | tau half_dt |
    # out work | B n m n_iter | floor_fac | cluster kc smem_bytes | stream
    lib.vch_bicgstab_adjoint_raw_cluster.argtypes = (
        [_P] * 12 + [ctypes.c_float] * 2 + [_P] * 2 + [_I] * 4
        + [ctypes.c_float] + [_I] * 3 + [_P])
    # Vxi VyiT Vx VyT lam denom d rhs inv_dt_p tau_dt_p hk_p | inv_dt
    # tau_dt hk | out work | B n m n_iter | floor_fac | cluster kc
    # smem_bytes | stream
    lib.vch_bicgstab_schur_spectral_cluster.argtypes = (
        [_P] * 11 + [ctypes.c_float] * 3 + [_P] * 2 + [_I] * 4
        + [ctypes.c_float] + [_I] * 3 + [_P])
    # Lx LyT Vxi VyiT Vx VyT denom d rhs inv_dt_p tau_dt_p hk_p | inv_dt
    # tau_dt hk | out work | B n m n_iter | floor_fac | cluster kc
    # smem_bytes | stream
    lib.vch_bicgstab_schur_raw_cluster.argtypes = (
        [_P] * 12 + [ctypes.c_float] * 3 + [_P] * 2 + [_I] * 4
        + [ctypes.c_float] + [_I] * 3 + [_P])
    # the probes: the raw Schur solve's arguments (floor_fac unread)
    lib.vch_schur_nodots_cluster.argtypes = \
        lib.vch_bicgstab_schur_raw_cluster.argtypes
    lib.vch_schur_mmonly_cluster.argtypes = \
        lib.vch_bicgstab_schur_raw_cluster.argtypes
    for name in ("solve", "adjoint_raw", "schur", "schur_raw",
                 "schur_probe"):
        # members segment n m cluster kc smem_bytes
        query = getattr(lib, f"vch_{name}_cluster_max_clusters")
        query.argtypes = [_I] * 7
        query.restype = _I
        fields = getattr(lib, f"vch_{name}_cluster_workspace_fields")
        fields.argtypes = []
        fields.restype = _I
    # variant scal s0 s1 s2 Lx LyT Vxi VyiT Vx VyT f1 v | out |
    # B n m shared | cluster per_thread chunk smem_bytes | stream
    lib.vch_apply_2d.argtypes = ([_I, _P] + [ctypes.c_float] * 3 + [_P] * 8
                                 + [_P] + [_I] * 4 + [_I] * 4 + [_P])
    # dts phi0 u LT VinvT VT lam wts | hist nsolve bad work | B M n |
    # consts nconst | max_iter n_trips stagnation | cluster members kc
    # resident smem_bytes | stream
    lib.vch_march_fused_1d.argtypes = ([_P] * 8 + [_P] * 4 + [_I] * 3
                                       + [_FP, _I] + [_I] * 3 + [_I] * 5
                                       + [_P])
    # n cluster members kc resident smem_bytes
    lib.vch_march1d_max_clusters.argtypes = [_I] * 6
    lib.vch_march1d_max_clusters.restype = _I
    lib.vch_march_1d_workspace_fields.argtypes = []
    lib.vch_march_1d_workspace_fields.restype = _I
    # A X out work | B n K L bf16 | stream
    lib.vch_matmul_chain.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    # A X out work | B n K L | cluster kc smem_bytes | stream
    lib.vch_matmul_chain_cluster.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    # A X out | B n K L | stream
    lib.vch_matmul_chain_mma.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    # members segment n m cluster kc smem_bytes
    lib.vch_chain_cluster_max_clusters.argtypes = [_I] * 7
    lib.vch_chain_cluster_max_clusters.restype = _I
    # variant | C X out work sums | n bb k | stream
    lib.vch_blocked_microbench.argtypes = [_I] + [_P] * 5 + [_I] * 3 + [_P]
    # variant | C X out work sums | n bb k | cluster kc smem_bytes | stream
    lib.vch_blocked_microbench_cluster.argtypes = ([_I] + [_P] * 5 + [_I] * 3
                                                   + [_I] * 3 + [_P])
    # members segment n m cluster kc smem_bytes
    lib.vch_micro_cluster_max_clusters.argtypes = [_I] * 7
    lib.vch_micro_cluster_max_clusters.restype = _I
    # x out ns | B n M | stream
    lib.vch_while_probe.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    lib.vch_while_max_elems.argtypes = []
    lib.vch_while_max_elems.restype = _I
    # x out ns | B n M | stream
    lib.vch_while_fused.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    lib.vch_while_fused_max_elems.argtypes = []
    lib.vch_while_fused_max_elems.restype = _I
    for fn in (lib.vch_march_fused_2d, lib.vch_march_fused_2d_cluster,
               lib.vch_march_fused_2d_blocked,
               lib.vch_march_fused_2d_segment,
               lib.vch_march_fused_2d_segment_cluster,
               lib.vch_adjoint_fused_2d, lib.vch_adjoint_fused_2d_segment,
               lib.vch_adjoint_fused_2d_blocked,
               lib.vch_adjoint_fused_2d_cluster,
               lib.vch_adjoint_fused_2d_segment_cluster,
               lib.vch_bicgstab_2d, lib.vch_bicgstab_adjoint_spectral_cluster,
               lib.vch_bicgstab_adjoint_raw_cluster,
               lib.vch_bicgstab_schur_spectral_cluster,
               lib.vch_bicgstab_schur_raw_cluster,
               lib.vch_schur_nodots_cluster, lib.vch_schur_mmonly_cluster,
               lib.vch_apply_2d,
               lib.vch_march_fused_1d, lib.vch_matmul_chain,
               lib.vch_matmul_chain_cluster, lib.vch_matmul_chain_mma,
               lib.vch_blocked_microbench,
               lib.vch_blocked_microbench_cluster, lib.vch_while_probe,
               lib.vch_while_fused):
        fn.restype = _I
    lib.vch_error_string.argtypes = [_I]
    lib.vch_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def on_cuda(name, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def check_cuda(named, dev):
    """Every (name, tensor, shape) of a launch: on `dev`, float32,
    contiguous, of the expected shape."""
    for name, t, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


def raise_on(lib, err, what):
    if err != 0:
        msg = lib.vch_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
