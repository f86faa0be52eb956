"""Which implementation each device op uses, by the platform JAX runs on.

Every choice that depends on the accelerator is made here and nowhere
else. Two platforms are known: ``cpu`` (tests and the host reference
runs) and ``gpu`` (an NVIDIA H100). Any other platform is an error, not a
silent fallback.

The GPU choices come from measurements on one H100 (``chip_smoke.py``
prints them; PERF.md records the numbers):

- ``device_kmer62``: k>31 counting (tadpole k=62) extracts, sorts and
  reduces on the device instead of the host radix sort.
- ``device_merge``: bbmerge runs its insert scan, mate selection,
  entropy and efilter steps as one device graph instead of host numpy.
- ``msa_kernel``: bbmap's unpruned DP fill runs the CUDA wavefront kernel
  (ops/cuda/msa_fill.cu) instead of the XLA scan (ops/msa.py).

On the CPU every choice takes the host-friendly side: host counting and
merging, and the XLA scan.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Choices:
    device_kmer62: bool
    device_merge: bool
    msa_kernel: bool


CHOICES = {
    "cpu": Choices(device_kmer62=False, device_merge=False, msa_kernel=False),
    # measured on one H100 (PERF.md): device counting beats the host
    # radix sort for k=62; the device merge graph beats host numpy 17x;
    # the CUDA fill beats the XLA scan 8-15x
    "gpu": Choices(device_kmer62=True, device_merge=True, msa_kernel=True),
}


def platform() -> str:
    """The platform of JAX's default device."""
    import jax

    return jax.devices()[0].platform


def choices(name: str | None = None) -> Choices:
    """The choices for platform `name` (default: the running one)."""
    name = platform() if name is None else name
    try:
        return CHOICES[name]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: bbtools_tpu runs on "
            f"{sorted(CHOICES)}"
        ) from None


@contextmanager
def override(**changes):
    """Run a block with some of the running platform's choices flipped:
    how chip_smoke.py times both sides of a choice, and how the CPU tests
    reach the GPU-side code paths."""
    name = platform()
    saved = choices(name)
    CHOICES[name] = replace(saved, **changes)
    try:
        yield CHOICES[name]
    finally:
        CHOICES[name] = saved
