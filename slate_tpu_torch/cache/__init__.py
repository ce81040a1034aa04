"""Shape buckets for serving: pad-and-crop dispatch into a small set of
problem orders (:mod:`.buckets`). The JAX package's executable cache
(``jitcache``, ``store``) and its warm-up CLI have no counterpart yet:
theirs would be CUDA-graph reuse."""

from . import buckets

__all__ = ["buckets"]
