"""The band width of the two-stage pipelines (counterpart of
``preferred_eig_band`` in ``slate_tpu/internal/band_wave_vmem.py:599-613``).

The JAX package keeps the whole band ribbon in a TPU core's VMEM; its
gate ``vmem_applies`` is that memory's budget and its 128-lane τ tile.
The port's chase kernels (``csrc/hb2st_chase.cu``, ``csrc/band_chase.cu``,
wrapped by :func:`.kernels.hb2st_chase` and :func:`.kernels.tb2bd_chase`)
keep the ribbon in device memory, so the gate here is the kernels' own
limits in :data:`.kernels.CAPABILITY` (float32, float64, complex64,
complex128; a band of at most 256) and the band each type runs fastest
at.
"""

from __future__ import annotations

import torch

from . import kernels

# The JAX package's band where its chase kernel does not apply.
DEFAULT_EIG_BAND = 256
# The band of the chase kernels by type on the card. float32 keeps the
# JAX package's 128 (its two task blocks fit shared memory there). The
# wider types' blocks leave shared memory above band 101 (complex128: 71),
# and at n = 8192 (complex128 4096) band 64 chased 2.0–3.0× faster than
# 128 (chip_smoke.py phase 2i; NVIDIA H100 80GB HBM3, 700 W): K8 float64
# 138.6 against 420.5 ms, complex64 153.3 against 413.3, complex128
# 97.1 against 279.4; K9 163.7/386.6, 202.3/404.9, 117.7/311.9.
CARD_EIG_BAND = {torch.float32: 128, torch.float64: 64,
                 torch.complex64: 64, torch.complex128: 64}


def preferred_eig_band(n: int, dtype: torch.dtype, device) -> int:
    """Band width of the two-stage pipelines: :data:`CARD_EIG_BAND` of
    ``dtype`` where the chase kernels take (n, that band, dtype) on the
    card (the chase is the pipeline's largest stage and grows with the
    band), else :data:`DEFAULT_EIG_BAND`. Both chasers share one
    capability row, so one gate serves heev and gesvd."""
    band = CARD_EIG_BAND.get(dtype)
    if (band is not None and torch.device(device).type == "cuda" and n >= 2
            and kernels.supported("hb2st_vmem", dtype, band, "cuda")):
        return band
    return DEFAULT_EIG_BAND
