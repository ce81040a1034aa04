#!/usr/bin/env python3
"""Where the time of ``gesv_batched`` goes on one CUDA card, beside
``lu_factor_ex`` + ``lu_solve`` on the same stack.

    python3 tools/serve_batched_trace.py [--root DIR] [--label NAME]

``--root`` is a checkout of the repository (default: this one) whose
``slate_tpu_torch`` is run; the stacks are those of ``chip_smoke.py``'s
3y (``BATCH_STACKS``, ``batched_stack``, f32: [64, 1024, 1024] with 8
right-hand sides at nb 256, [1024, 256, 256] with 1 at nb 128), so two
trees can be compared on one card in one command (parent, change,
change, parent). For each stack and each of the two calls: the median
wall time of five calls (host clock, the card synchronised after each),
then one call under ``torch.profiler``: the device's busy time (the
union of its kernels' and copies' intervals), the idle time the wall
leaves beside it, the host's waits for the card (the runtime calls that
synchronise: device-to-host copies and stream synchronisations) with
their count, and the device kernels with the most time.
Prints one JSON object per line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaMemcpyAsync", "cudaMemcpy", "cudaEventSynchronize")


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace(fn):
    """One call of ``fn`` under torch.profiler: wall, device busy and
    idle ms, the host's waits and the top device kernels."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, waits, kernels = [], [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start, e.time_range.end))
            kernels[e.name[:70]] = (kernels.get(e.name[:70], 0.0)
                                    + e.time_range.elapsed_us())
        elif e.name in WAITS:
            waits.append(e.time_range.elapsed_us())
    busy = union_us(dev)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(trace_wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle_ms=(wall_us - busy) / 1e3,
                host_waits=len(waits), host_wait_ms=sum(waits) / 1e3,
                top_kernels_ms={k: round(v / 1e3, 4) for k, v in top})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_batched_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import slate_tpu_torch as st

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    for si, (batch, n, nrhs, nb) in enumerate(cs.BATCH_STACKS):
        _, gen_a, b = cs.batched_stack(batch, n, nrhs, 160 + si)
        calls = {
            "gesv_batched": lambda: st.gesv_batched(gen_a, b),
            "lu_factor_ex + lu_solve": lambda: torch.linalg.lu_solve(
                *torch.linalg.lu_factor_ex(gen_a)[:2], b)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps(dict(call=name, stack=[batch, n, n], nrhs=nrhs,
                                  nb=nb, wall_ms=statistics.median(walls),
                                  walls_ms=walls, **trace(fn),
                                  label=args.label, device=smi)),
                  flush=True)
        del gen_a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
