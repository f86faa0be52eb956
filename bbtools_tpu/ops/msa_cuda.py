"""bbmap's DP fill with traceback planes: the CUDA wavefront kernel on the
GPU, the XLA scan (ops/msa.py msa_fill) elsewhere.

The XLA scan launches at least one kernel per anti-diagonal (R+Cc-1 of
them: 325 for the narrowest window class at R=151, 2,373 for the widest)
and moves the d-1/d-2 state planes through device memory at every step.
The kernel (ops/cuda/msa_fill.cuh) runs one warp per alignment with the
whole diagonal loop inside one launch and the state in registers; only
the uint8 traceback planes and the three per-task results are written.
Both produce bit-identical scores, columns, states and planes.

The kernel is compiled for sm_90a with nvcc at first use into
``<checkout>/.build`` and registered as an XLA FFI target.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp

from .. import CHECKOUT
from ..core import backend
from . import msa_constants as C
from .msa import col0_scores, msa_fill

SRC_DIR = os.path.join(os.path.dirname(__file__), "cuda")
SOURCES = ("msa_fill.cu", "msa_fill.cuh")
TARGET = "bbt_msa_fill"
#: one warp holds R+1 rows at up to 8 per lane
MAX_ROWS = 32 * 8

_LIB = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "the CUDA MSA kernel needs nvcc (the CUDA toolkit) to build"
        )
    return path


def build_library() -> str:
    """Compile the kernel once per source digest; returns the .so path."""
    h = hashlib.sha256()
    for s in SOURCES:
        with open(os.path.join(SRC_DIR, s), "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(CHECKOUT, ".build")
    lib = os.path.join(out_dir, f"libbbt_msa_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp,
        os.path.join(SRC_DIR, "msa_fill.cu"),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _register() -> None:
    global _LIB
    if _LIB is None:
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.BbtMsaFill), platform="CUDA"
        )
        _LIB = lib


def use_kernel(R: int) -> bool:
    """The CUDA fill serves read widths up to MAX_ROWS - 1 on the GPU."""
    return backend.choices().msa_kernel and R + 1 <= MAX_ROWS


def dp_bucket(n: int) -> int:
    """Padded task count of a DP class. The kernel takes any count (one
    warp per task, four per block); the buckets only bound how many
    shapes get compiled, since every new shape recompiles bbmap's whole
    fused step: 8, 32, then powers of two."""
    return 8 if n <= 8 else 32 if n <= 32 else 1 << (n - 1).bit_length()


def _fill_cuda(R, Cc, reads, read_lens, refs):
    _register()
    B = reads.shape[0]
    i32 = jax.ShapeDtypeStruct((B,), jnp.int32)
    planes = jax.ShapeDtypeStruct((R + Cc - 1, B, R + 1), jnp.uint8)
    return jax.ffi.ffi_call(TARGET, (i32, i32, i32, planes))(
        reads, read_lens, refs, jnp.full(B, Cc, jnp.int32),
        jnp.asarray(col0_scores(R), jnp.int32),
    )


def _fill_xla(R, Cc, reads, read_lens, refs):
    # the unpruned fill reads only subfloor; vert/horiz/floor bound the
    # pruned variant and are passed as zeros
    B = reads.shape[0]
    i32 = jnp.int32
    maxgain = (read_lens - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    return msa_fill(
        R, Cc, False, True, reads, read_lens, refs, jnp.full(B, Cc, i32),
        jnp.zeros((B, R + 1), i32), jnp.zeros((B, Cc + 1), i32),
        jnp.zeros(B, i32), (-2 * maxgain).astype(i32),
    )


@partial(jax.jit, static_argnames=("R", "Cc"))
def msa_fill_tb(R: int, Cc: int, reads, read_lens, refs):
    """Unpruned fill (fillUnlimited) with traceback planes for tasks whose
    reference windows are all Cc wide. reads u8 [B, R], read_lens [B],
    refs u8 [B, Cc]. Returns (max_score, max_col, max_state) int32 [B]
    and planes u8 [R+Cc-1, B, R+1] in msa_walk's layout."""
    reads = reads.astype(jnp.uint8)
    refs = refs.astype(jnp.uint8)
    read_lens = read_lens.astype(jnp.int32)
    fill = _fill_cuda if use_kernel(R) else _fill_xla
    return fill(R, Cc, reads, read_lens, refs)
