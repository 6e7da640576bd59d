"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface.  At first CUDA use each is
compiled with ``nvcc`` for ``sm_90a`` (all files at once, one process each),
linked into one shared library under ``build/repro_torch/`` in the checkout,
and loaded with ``ctypes``.  The library's name carries a hash of the sources,
the headers they include (``csrc/*.cuh``) and the flags, so an edited source
or header is rebuilt and an unchanged tree is reused.
A failed build raises.  Nothing here runs at import time, so the package
imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float          # 0.0 when an existing build was reused
    log: str                # nvcc/ptxas output (registers, spills)

    def kernels(self) -> list:
        """Registers and spill bytes per kernel (by its mangled name), from
        ``-Xptxas -v``."""
        rows, cur = [], None
        for ln in self.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = {"kernel": m.group(1)}
                rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
        return rows


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _headers() -> list:
    return sorted(SRC_DIR.glob("*.cuh"))


def _run_all(cmds) -> str:
    """Start every command at once; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = None
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"kernel build failed (exit {rc}): "
                           f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for s in srcs + _headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libreprotorch_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(srcs, objs)])
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return BuildResult(lib, time.perf_counter() - t0, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spmm_csr_f32.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.spmm_csr_f32.restype = i32
    # q, k, v, out, kv_len, strides, B, Hq, Hkv, Lq, Lk, D, causal, scale
    flash = ([ptr] * 5 + [ctypes.POINTER(ctypes.c_int64)] + [i32] * 7
             + [ctypes.c_float])
    lib.flash_attention_fwd.argtypes = flash + [i32, ptr]
    lib.flash_attention_prefill_bf16.argtypes = flash + [ptr]
    lib.flash_attention_decode.argtypes = flash + [i32, i32] + [ptr] * 5
    # dq: q, k, v, out, dout, dq, lse, delta, kv_len; dkdv: q, k, v, dout,
    # dk, dv, lse, delta, kv_len; then both: strides (32), B, Hq, Hkv, Lq,
    # Lk, D, causal, scale, dtype, stream
    bwd = ([ptr] * 9 + [ctypes.POINTER(ctypes.c_int64)] + [i32] * 7
           + [ctypes.c_float, i32, ptr])
    lib.flash_attention_bwd_dq.argtypes = bwd
    lib.flash_attention_bwd_dkdv.argtypes = bwd
    # The tensor-core backward: the same arguments, bf16 only (no dtype).
    lib.flash_attention_bwd_tc_dq.argtypes = bwd[:-2] + [ptr]
    lib.flash_attention_bwd_tc_dkdv.argtypes = bwd[:-2] + [ptr]
    for fn in (lib.flash_attention_fwd, lib.flash_attention_prefill_bf16,
               lib.flash_attention_decode, lib.flash_attention_bwd_dq,
               lib.flash_attention_bwd_dkdv, lib.flash_attention_bwd_tc_dq,
               lib.flash_attention_bwd_tc_dkdv):
        fn.restype = i32
    # msg, order, keys, offsets, out, part, E, n, d, stream
    # (csrc/segment_sum.cu)
    lib.segment_sum_f32.argtypes = ([ptr] * 6 + [ctypes.c_int64] * 2
                                    + [i32, ptr])
    lib.segment_sum_f32.restype = i32
    lib.segment_sum_tile.argtypes = []
    lib.segment_sum_tile.restype = i32
    # slots, head, capacity, phase, stream (csrc/mark.cu)
    lib.repro_torch_mark.argtypes = [ptr, ptr, ctypes.c_int64, i32, ptr]
    lib.repro_torch_mark.restype = i32
    lib.repro_torch_cuda_error_string.argtypes = [i32]
    lib.repro_torch_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_torch_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
