"""The band width of the two-stage pipelines (counterpart of
``preferred_eig_band`` in ``slate_tpu/internal/band_wave_vmem.py:599-613``).

The JAX package keeps the whole band ribbon in a TPU core's VMEM; its
gate ``vmem_applies`` is that memory's budget and its 128-lane τ tile.
The port's chase kernels (``csrc/band_chase.cu``, wrapped by
:func:`.kernels.hb2st_chase` and :func:`.kernels.tb2bd_chase`) keep the
ribbon in device memory, so the gate here is the kernels' own limits in
:data:`.kernels.CAPABILITY`: float32 and a band of at most 256.
"""

from __future__ import annotations

import torch

from . import kernels

# The JAX package's band where its chase kernel does not apply.
DEFAULT_EIG_BAND = 256


def preferred_eig_band(n: int, dtype: torch.dtype, device) -> int:
    """Band width of the two-stage pipelines: 128 where the chase kernels
    take (n, 128, dtype) on the card (the chase is the pipeline's largest
    stage and grows with the band), else :data:`DEFAULT_EIG_BAND`. Both
    chasers share one capability row, so one gate serves heev and
    gesvd."""
    if (torch.device(device).type == "cuda" and n >= 2
            and kernels.supported("hb2st_vmem", dtype, 128, "cuda")):
        return 128
    return DEFAULT_EIG_BAND
