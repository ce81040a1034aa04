"""Ragged front end: pack mixed-order requests into bucket-shaped batches
(the port's copy of ``slate_tpu/serve/ragged.py``).

Every request is embedded into the ``cache/buckets.py`` table by the
identity pad-and-crop embedding ``[[A, 0], [0, I]]``, grouped by
(routine, bucket, tier, verify) in submission order, and each group runs
as a few ``serve.batched`` calls whose batch sizes come off a
power-of-two ladder: a group of 21 runs as 16 + 4 + 1, and no dummy
member is ever factored.

Observability: a ``serve.dispatch`` span a chunk (host clock, around the
solve and the copy of its result to the host), ``serve.latency_s`` and
``serve.stage_s`` histograms, the ``serve.requests`` counter, and the
padded-waste series (``serve.padded_waste_frac``, ``serve.padded_flops``,
``serve.real_flops``): the share of issued flops spent on bucket
padding, under the JAX package's names and labels.

Fault injection: an armed ``nan_tile`` or ``singular_pivot`` fault
corrupts exactly one seed-chosen member of each group, which must report
through its own ``HealthReport`` while its batchmates' answers stay
right.

Requests carry numpy arrays and results come back as numpy arrays on the
host; the solves run on ``device`` (the CUDA card when None).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import obs
from ..internal.precision import resolve_tier
from ..obs import correlation
from ..obs.flops import flop_count
from ..robust import faults
from ..robust.guards import HealthReport, health_report
from . import batched

# info conventions per routine
_CONVENTION = {"posv": "first_block", "gesv": "count"}


@dataclasses.dataclass
class SolveRequest:
    """One solve ``a @ x = b`` (``a`` square, ``b`` 1-D or 2-D).

    ``routine`` is ``"posv"`` (SPD) or ``"gesv"`` (general, partial
    pivoting); ``opts`` may carry ``Option.TrailingPrecision``; ``tag``
    rides through to the matching :class:`SolveResult`. Every request
    mints a process-unique ``rid`` (or adopts the one passed), stamped
    on its ``HealthReport``; ``tenant`` and ``slo_class`` are the
    low-cardinality labels of the serve series. ``verify=True`` runs a
    host residual check of this request's solution
    (``robust/abft.verify_solve``) and is part of the group key.
    ``t_submit`` is the zero point of the stage seconds, ``stages`` the
    stage seconds already paid upstream."""

    a: np.ndarray
    b: np.ndarray
    routine: str = "posv"
    opts: dict | None = None
    tag: object = None
    rid: str = ""
    tenant: str = "default"
    slo_class: str = "standard"
    verify: bool = False
    t_submit: float = 0.0
    stages: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.rid:
            self.rid = correlation.new_id()
        if not self.t_submit:
            self.t_submit = time.time()


@dataclasses.dataclass
class SolveResult:
    """Outcome of one request, in submission order: ``x`` with ``b``'s
    ndim, the request's :class:`HealthReport` (``health.ok`` means served
    and numerically clean), its order, bucket and rung, the chunk's wall
    seconds, the stage seconds (queue, pack, solve, crop: they sum to
    ``t_done − t_submit``) and ``rid``."""

    tag: object
    x: np.ndarray | None
    health: HealthReport | None
    n: int
    bucket: int
    rung: int = 0
    wall_s: float = 0.0
    rid: str = ""
    stages: dict = dataclasses.field(default_factory=dict)
    t_done: float = 0.0


def batch_rungs(count: int) -> list[int]:
    """Greedy power-of-two decomposition, largest rung first:
    21 → [16, 4, 1]."""
    if count <= 0:
        return []
    out, r = [], 1
    while r * 2 <= count:
        r *= 2
    while count:
        if r <= count:
            out.append(r)
            count -= r
        else:
            r //= 2
    return out


def _corruption_plan(routine: str, count: int) -> list[tuple[str, int]]:
    """Each armed ``nan_tile`` / ``singular_pivot`` fault names one
    seed-chosen member of the group to corrupt."""
    plan = []
    for kind in ("nan_tile", "singular_pivot"):
        spec = faults.enabled(kind, routine)
        if spec is not None:
            plan.append((kind, spec.seed % count))
    return plan


def _apply_corruption(routine, plan, stack_a, chunk, base):
    """Apply the group's corruption plan to the members of this chunk
    (``base``: the chunk's offset in the group)."""
    for kind, gidx in plan:
        j = gidx - base
        if not 0 <= j < len(chunk):
            continue
        n = np.asarray(chunk[j].a).shape[0]
        if kind == "nan_tile":
            stack_a[j, :2, :2] = np.nan
        else:
            col = gidx % n
            stack_a[j, :, col] = 0.0
            stack_a[j, col, :] = 0.0
        with correlation.bind(chunk[j].rid):
            faults.record(kind, f"serve.{routine}",
                          f"group member {gidx} (n={n})")
    return stack_a


def _group_key(req: SolveRequest, table, nb, default_opts, policy):
    from ..cache import buckets
    n = np.asarray(req.a).shape[0]
    bucket = buckets.bucket_for(n, table, nb, policy=policy)
    tier = resolve_tier(req.opts if req.opts is not None else default_opts)
    return req.routine, bucket, tier, bool(req.verify)


def solve_ragged(requests, *, nb: int | None = None, table=None,
                 opts=None, policy: str = "grow", sched: str = "direct",
                 on_result=None, device=None) -> list[SolveResult]:
    """Serve a list of :class:`SolveRequest` through bucketed batched
    solves; returns :class:`SolveResult` in submission order.

    ``policy`` goes to ``buckets.bucket_for`` (``"reject"`` raises for an
    order above the table). ``sched`` labels the per-request serve
    series (``"direct"``: no scheduler). ``on_result(req, res)`` is
    called as soon as a request's result is complete, before the rest of
    its group. ``device`` is where the stacks are solved."""
    requests = list(requests)
    for r in requests:
        if r.routine not in _CONVENTION:
            raise ValueError(
                f"solve_ragged: unknown routine {r.routine!r} "
                f"(expected one of {sorted(_CONVENTION)})")

    groups: dict[tuple, list[int]] = {}
    for i, req in enumerate(requests):
        groups.setdefault(
            _group_key(req, table, nb, opts, policy), []).append(i)

    results: list[SolveResult | None] = [None] * len(requests)
    for key in sorted(groups):
        routine, bucket, tier = key[0], key[1], key[2]
        idxs = groups[key]
        _dispatch_group(routine, bucket, tier, nb,
                        [requests[i] for i in idxs], idxs, results,
                        sched, on_result, device)
    return [r for r in results if r is not None]


def _nrhs(b) -> int:
    b = np.asarray(b)
    return b.reshape(b.shape[0], -1).shape[1]


def _dispatch_group(routine, bucket, tier, nb, members, idxs, results,
                    sched, on_result, device):
    """One (routine, bucket, tier) group as ladder-rung chunks, filling
    ``results`` at ``idxs``."""
    from ..types import Option
    nrhs = max(_nrhs(m.b) for m in members)
    real_flops = sum(flop_count(routine, n=np.asarray(m.a).shape[0],
                                nrhs=nrhs) for m in members)
    padded_flops = len(members) * flop_count(routine, n=bucket, nrhs=nrhs)
    waste = 1.0 - real_flops / padded_flops if padded_flops else 0.0
    obs.gauge("serve.padded_waste_frac", waste, routine=routine,
              bucket=str(bucket))
    obs.count("serve.padded_flops", padded_flops - real_flops,
              routine=routine, bucket=str(bucket))
    obs.count("serve.real_flops", real_flops, routine=routine,
              bucket=str(bucket))

    solve_opts = {Option.TrailingPrecision: tier}
    plan = _corruption_plan(routine, len(members))
    pos = 0
    for rung in batch_rungs(len(members)):
        _dispatch_chunk(routine, bucket, tier, nb, nrhs,
                        members[pos:pos + rung], idxs[pos:pos + rung],
                        results, solve_opts, plan, pos, sched, on_result,
                        device)
        pos += rung


def _dispatch_chunk(routine, bucket, tier, nb, nrhs, chunk, chunk_idx,
                    results, solve_opts, plan, base, sched, on_result,
                    device):
    from ..cache import buckets
    t_start = time.time()
    dt = np.result_type(*(np.asarray(m.a).dtype for m in chunk))
    stack_a = np.stack([buckets.pad_embed(np.asarray(m.a, dtype=dt), bucket)
                        for m in chunk])
    stack_b = np.stack([buckets.pad_rhs(_pad_cols(m.b, nrhs, dt), bucket)
                        for m in chunk])
    stack_a = _apply_corruption(routine, plan, stack_a, chunk, base)

    chunk_flops = sum(flop_count(routine, n=np.asarray(m.a).shape[0],
                                 nrhs=nrhs) for m in chunk)
    t_pack = time.time()
    with correlation.bind(*(m.rid for m in chunk)):
        with obs.span("serve.dispatch", routine=routine,
                      bucket=str(bucket), b=len(chunk), n=bucket,
                      nrhs=nrhs, precision=tier, flops=chunk_flops):
            if routine == "posv":
                x, _, info = batched.batched_posv(
                    stack_a, stack_b, solve_opts, nb=nb, device=device)
            else:
                x, _, _, info = batched.batched_gesv(
                    stack_a, stack_b, solve_opts, nb=nb, device=device)
            x = x.cpu().numpy()
            info = info.cpu().numpy()
    t_call = time.time()
    wall = t_call - t_pack

    for j, (req, ridx) in enumerate(zip(chunk, chunk_idx)):
        n = np.asarray(req.a).shape[0]
        xi = x[j, :n, :_nrhs(req.b)]
        if np.asarray(req.b).ndim == 1:
            xi = xi[:, 0]
        verified = checksum_resid = None
        if req.verify and int(info[j]) == 0:
            from ..robust import abft
            with correlation.bind(req.rid):
                verified, checksum_resid = abft.verify_solve(
                    routine, np.asarray(req.a), np.asarray(req.b), xi, tier)
        health = health_report(
            routine, int(info[j]), convention=_CONVENTION[routine],
            notes=f"bucket={bucket} rung={len(chunk)} tier={tier}",
            request_id=req.rid, verified=verified,
            checksum_resid=checksum_resid)
        obs.observe("serve.latency_s", wall, routine=routine,
                    bucket=str(bucket), tenant=req.tenant,
                    slo_class=req.slo_class, sched=sched)
        obs.count("serve.requests", routine=routine, bucket=str(bucket),
                  ok=("yes" if health.ok else "no"), tenant=req.tenant,
                  slo_class=req.slo_class, sched=sched)
        results[ridx] = SolveResult(
            tag=req.tag, x=xi, health=health, n=n, bucket=bucket,
            rung=len(chunk), wall_s=wall, rid=req.rid)

    # the stages: the chunk's phases are shared by its members, the queue
    # is each member's own (chunk start − submit − stages already paid).
    # The JAX package's "dispatch" (a scheduler's hand-off) and "compile"
    # stages wait for the scheduler and the executable cache
    t_end = time.time()
    here_shared = dict(pack=t_pack - t_start, solve=wall,
                       crop=t_end - t_call)
    for req, ridx in zip(chunk, chunk_idx):
        res = results[ridx]
        paid = dict(req.stages)
        here = dict(queue=max(t_start - req.t_submit - sum(paid.values()),
                              0.0), **here_shared)
        paid.update(here)
        res.stages = paid
        res.t_done = t_end
        for st, sv in here.items():
            obs.observe("serve.stage_s", sv, stage=st, routine=routine,
                        tenant=req.tenant, slo_class=req.slo_class,
                        sched=sched)
        if on_result is not None:
            on_result(req, res)


def _pad_cols(b, nrhs: int, dt):
    """A request's right-hand sides widened to the group's column count
    with zero columns (they solve to zero and are cropped away)."""
    b = np.asarray(b, dtype=dt)
    b2 = b.reshape(b.shape[0], -1) if b.ndim == 1 else b
    if b2.shape[1] == nrhs:
        return b2
    out = np.zeros((b2.shape[0], nrhs), dtype=dt)
    out[:, :b2.shape[1]] = b2
    return out
