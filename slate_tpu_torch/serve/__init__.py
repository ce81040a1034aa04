"""Serving: batched solves over a leading axis (:mod:`.batched`) and the
ragged front end that packs mixed-order requests into bucket-shaped
batches (:mod:`.ragged`), the port's copies of those layers of
``slate_tpu/serve``. The scheduler, the continuous-batching flow, the
load generator and the CLI are not ported yet."""

from .batched import (batched_gesv, batched_getrf, batched_posv,
                      batched_potrf, batched_trsm)
from .ragged import SolveRequest, SolveResult, batch_rungs, solve_ragged

__all__ = [
    "batched_potrf", "batched_getrf", "batched_trsm", "batched_posv",
    "batched_gesv", "SolveRequest", "SolveResult", "batch_rungs",
    "solve_ragged",
]
