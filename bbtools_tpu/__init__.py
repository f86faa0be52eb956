"""bbtools_tpu — an accelerator-native sequence-analysis framework.

A from-scratch JAX/XLA re-design of the capabilities of BBTools
(reference: bbushnell/BBTools v40.02). Not a port: the compute path is
batched, fixed-shape, and functional so it maps onto a GPU through
XLA's compilation model; the host path (IO, compression, orchestration) is
an async pipeline feeding device batches.

Layout (mirrors SURVEY.md §7):
  core/      — global config, flag parsing, DNA codecs, timers
  io/        — file formats, FASTQ/FASTA/SAM codecs, batch streaming
  ops/       — device kernels: k-mer extraction, hash/sort indexes,
               banded alignment DP, overlap scan, entropy (jnp + CUDA)
  models/    — the user-facing tools (bbduk, bbmap, bbmerge, tadpole,
               callvariants, ...), each a thin driver over ops/ + io/
  parallel/  — mesh construction, sharding policies, collectives
  utils/     — stats/histograms, synthetic-read generators, graders
"""

# 64-bit integers are required for k-mer keys (k<=31 -> up to 62 bits).
# This must run before any jax array is created. All code in this package
# passes explicit dtypes; enabling x64 does not change our float widths.
import os

import jax

jax.config.update("jax_enable_x64", True)

#: the directory that holds the package: build outputs and the default
#: compile cache live under it
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


# Persistent compile cache for every entry point (CLI, chip_smoke, bench,
# tools): a cold process recompiles each pipeline's graphs otherwise.
jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

# Keep multi-MB host buffers on the malloc heap instead of per-allocation
# mmaps: under gVisor a fresh mmap costs ~2 us of first-touch fault per
# 4 KB page, which made the streaming readers allocation-bound (a 1.3 MB
# batch plane cost ~2 ms to touch, ~60 ms per 32 MB chunk — measured).
# With the mmap threshold raised, freed planes are handed straight back
# to the next batch with pages already resident. glibc-only; silently
# skipped elsewhere.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL("libc.so.6")
    _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
    _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
except Exception:
    pass

__version__ = "0.1.0"
