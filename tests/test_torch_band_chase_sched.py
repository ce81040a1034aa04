"""The schedule of the two bulge-chase kernels, K8 (band → tridiagonal,
csrc/hb2st_chase.cu) and K9 (band → bidiagonal, csrc/band_chase.cu), on
the persistent loop of csrc/chase_flow.cuh, modelled on the host.

Each kernel runs its whole chase in one cooperative launch: CTA x of G
takes the sweeps x, x + G, …, and each task (s, t) of a sweep in three
parts. The early part (k = 0) reads what sweep s − 1 has finished with
once its task t is done; the rest of stage 1 (k = 1) reads the elements
that (s − 1, t + 1) writes in its first stage and writes the task's bulge
block B (for t = 0 the row or column s), then publishes stage[s] = t + 1;
stage 2 (k = 2) reads the last diagonal element of the diagonal block D,
which (s − 1, t + 1) writes in its second stage, writes D and publishes
done[s] = t + 1. Part 0 waits for done[s − 1] ≥ t + 1, part 1 for
stage[s − 1] ≥ t + 2, part 2 for done[s − 1] ≥ t + 2 (each capped at
the length of sweep s − 1). The two chases differ in what the late
elements are:

* K8 (hebr, lower storage): B's and D's last row; D keeps its lower
  triangle only.
* K9 (gebr, upper band with its fill): B's last element B[b − 1, L − 1]
  (for t = 0 the last element of row s) and D's last column; D is the
  whole square block, whose lower part holds the fill that the next
  sweep chases.

The model below checks, for several (n, b), b > 128 and b ≥ n among
them, and for both chases:

* every part is ordered, by its sweep's program order and those waits,
  after every part that the twin's order (sweep by sweep, task by task)
  puts before it and that writes an element it touches, or touches an
  element it writes: its inputs are final when read, and no two parts
  that may run at once write what the other touches;
* every element a part touches lies in the slots the ribbon keeps for it
  (K8: the lower half, r − c ≤ 2b − 1; K9: −(b − 1) ≤ c − r ≤ 2b − 1);
* G co-resident CTAs, 1 ≤ G ≤ n, finish without a deadlock;
* random interleavings of the parts that the waits allow, run with the
  task body in float64 (what part 0 reads kept until parts 1 and 2 use
  it), give the sequential order's results bit for bit, and those agree
  with ``band_bulge.hb2st`` and ``band_bulge.tb2bd``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slate_tpu_torch.internal import band_bulge as bb
import tests.torch_cpu_threads  # noqa: E402,F401

SHAPES = [(12, 1), (17, 2), (40, 3), (41, 5), (30, 8), (20, 32), (131, 129)]
CHASES = ["hb2st", "tb2bd"]


def sweep_tasks(n, b, s):
    return (n - 2 - s) // b + 1


def stages(n, b):
    """Every part (s, t, k), k = 0, 1, 2, in the twin's order."""
    return [(s, t, k) for s in range(n - 1) for t in range(sweep_tasks(n, b, s))
            for k in (0, 1, 2)]


def waits(n, b, s, t, k):
    """The part whose published count part (s, t, k) waits for: done[]
    is published after part 2, stage[] after part 1."""
    if s == 0:
        return []
    tp = sweep_tasks(n, b, s - 1)
    cap = min(t + 1, tp) if k == 0 else min(t + 2, tp)
    return [(s - 1, cap - 1, 1 if k == 1 else 2)]


def accesses(chase, n, b, s, t, k):
    """(reads, writes) of part (s, t, k): sets of matrix elements (r, c)."""
    i0 = s + 1 + t * b
    L = min(b, n - i0)
    last = i0 + L - 1
    if chase == "hb2st":
        D = {(i0 + i, i0 + c) for i in range(L) for c in range(i + 1)}
        if k == 2:
            return {(last, last)}, D
        if t == 0:
            blk = {(i0 + i, s) for i in range(L)}
        else:
            blk = {(i0 + i, i0 - b + c) for i in range(L) for c in range(b)}
        if k == 0:
            return {e for e in blk | D if e[0] < last}, set()
        return {e for e in blk | D if e[0] == last and e != (last, last)}, blk
    D = {(i0 + i, i0 + c) for i in range(L) for c in range(L)}
    if k == 2:
        return {(last, last)}, D
    if t == 0:
        blk = {(s, i0 + c) for c in range(L)}
        late = (s, last)
    else:
        blk = {(i0 - b + i, i0 + c) for i in range(b) for c in range(L)}
        late = (i0 - 1, last)
    if k == 0:
        return ({e for e in D if e[1] < last} | blk) - {late}, set()
    return {late} | {e for e in D if e[1] == last and e != (last, last)}, blk


def in_ribbon(chase, b, r, c):
    if chase == "hb2st":
        return 0 <= r - c <= 2 * b - 1
    return -(b - 1) <= c - r <= 2 * b - 1


def ancestors(n, b):
    """Stage → bitset of the stages ordered before it by program order
    within a sweep and the waits (no CTA's order across sweeps: the
    check must hold for every G)."""
    order = stages(n, b)
    index = {x: i for i, x in enumerate(order)}
    anc = [0] * len(order)
    for i, (s, t, k) in enumerate(order):
        preds = list(waits(n, b, s, t, k))
        if k > 0:
            preds.append((s, t, k - 1))
        elif t > 0:
            preds.append((s, t - 1, 2))
        for p in preds:
            j = index[p]
            assert j < i  # every edge runs forward in the twin's order
            anc[i] |= anc[j] | (1 << j)
    return order, index, anc


@pytest.mark.parametrize("chase", CHASES)
@pytest.mark.parametrize("n,b", SHAPES)
def test_waits_order_every_conflict(chase, n, b):
    order, index, anc = ancestors(n, b)
    last_w: dict = {}
    readers: dict = {}
    for i, x in enumerate(order):
        reads, writes = accesses(chase, n, b, *x)
        for (r, c) in reads | writes:
            assert 0 <= r < n and 0 <= c < n and in_ribbon(chase, b, r, c), (
                x, r, c)
        for e in reads | writes:
            w = last_w.get(e)
            assert w is None or anc[i] >> w & 1, (order[w], x, e)
        for e in writes:
            for j in readers.get(e, ()):
                assert j == i or anc[i] >> j & 1, (order[j], x, e)
            last_w[e] = i
            readers[e] = []
        for e in reads - writes:
            readers.setdefault(e, []).append(i)


def run_schedule(n, b, G, pick):
    """Run the stages as G co-resident CTAs would, the next CTA to move
    chosen by ``pick`` among those whose waits are met; returns the
    stages in the order run, or raises on a deadlock."""
    queues = [[(s, t, k) for s in range(x, n - 1, G)
               for t in range(sweep_tasks(n, b, s)) for k in (0, 1, 2)]
              for x in range(G)]
    pos = [0] * G
    ran, out = set(), []
    total = sum(len(q) for q in queues)
    while len(out) < total:
        ready = [x for x in range(G) if pos[x] < len(queues[x])
                 and all(w in ran for w in waits(n, b, *queues[x][pos[x]]))]
        assert ready, f"deadlock with G = {G} after {len(out)} stages"
        x = pick(ready)
        st = queues[x][pos[x]]
        pos[x] += 1
        ran.add(st)
        out.append(st)
    return out


@pytest.mark.parametrize("chase", CHASES)
@pytest.mark.parametrize("n,b", SHAPES)
def test_no_deadlock(chase, n, b):
    # both kernels run the same loop and waits: the element sets (above)
    # are what differ; each case still drives its own random schedules
    rng = np.random.default_rng(n * b + (chase == "tb2bd"))
    for G in sorted({1, 2, 3, 7, n - 1, n}):
        run_schedule(n, b, G, lambda r: r[0])
        run_schedule(n, b, G, lambda r: r[-1])
        run_schedule(n, b, G, lambda r: r[rng.integers(len(r))])


def larfg(x):
    v, tau, beta = bb.larfg(torch.from_numpy(x.copy()))
    return v.numpy(), float(tau), float(beta)


class Hebr:
    """K8's task body on a dense float64 matrix whose lower triangle is
    the band, part by part, with what part 0 reads kept for parts 1 and
    2; the arithmetic of ``band_bulge.hb2st``."""

    def __init__(self, ab):
        b, n = ab.shape[0] - 1, ab.shape[1]
        self.n, self.b = n, b
        self.A = np.zeros((n, n))
        for d in range(min(b, n - 1) + 1):
            j = np.arange(n - d)
            self.A[j + d, j] = ab[d, :n - d]
        T = bb.max_chase(n, b)
        self.V = np.zeros((n - 1, T, b))
        self.tau = np.zeros((n - 1, T))
        self.kept = {}

    def stage(self, s, t, k):
        n, b, A = self.n, self.b, self.A
        i0 = s + 1 + t * b
        L = min(b, n - i0)
        j0 = i0 - b
        cols = slice(s, s + 1) if t == 0 else slice(j0, i0)
        if k == 0:  # all but the last rows, read; NaN marks what is not
            B = np.full((L, 1 if t == 0 else b), np.nan)
            D = np.full((L, L), np.nan)
            B[:L - 1] = A[i0:i0 + L - 1, cols]
            D[:L - 1] = np.tril(A[i0:i0 + L - 1, i0:i0 + L])
            self.kept[s, t] = B, D
            return
        B, D = self.kept[s, t]
        if k == 1:
            B[L - 1] = A[i0 + L - 1, cols]
            D[L - 1, :L - 1] = A[i0 + L - 1, i0:i0 + L - 1]
            if t == 0:
                v, tv, beta = larfg(B[:, 0])
                B[:] = 0.0
            else:
                vp, tp = self.V[s, t - 1], self.tau[s, t - 1]
                B -= np.outer(tp * (B @ vp), vp)
                v, tv, beta = larfg(B[:, 0])
                B[:, 1:] -= np.outer(tv * v, v @ B[:, 1:])
                B[:, 0] = 0.0
            B[0, 0] = beta
            A[i0:i0 + L, cols] = B
            self.V[s, t, :L] = v
            self.tau[s, t] = tv
            return
        del self.kept[s, t]
        D[L - 1, L - 1] = A[i0 + L - 1, i0 + L - 1]
        D = np.tril(D) + np.tril(D, -1).T
        v, tv = self.V[s, t, :L], self.tau[s, t]
        y = tv * (D @ v)
        w = y + (-0.5 * tv) * (v @ y) * v
        D -= np.outer(v, w) + np.outer(w, v)
        A[i0:i0 + L, i0:i0 + L] = np.where(np.tri(L, dtype=bool), D,
                                           A[i0:i0 + L, i0:i0 + L])

    def result(self):
        n = self.n
        return (np.diag(self.A).copy(), self.A[np.arange(1, n), np.arange(n - 1)].copy(),
                self.V, self.tau)


class Gebr:
    """K9's task body on a dense float64 matrix holding the upper band,
    part by part, with what part 0 reads kept for parts 1 and 2; the
    arithmetic of ``band_bulge.tb2bd``."""

    def __init__(self, ab):
        b, n = ab.shape[0] - 1, ab.shape[1]
        self.n, self.b = n, b
        self.A = np.zeros((n, n))
        for d in range(min(b, n - 1) + 1):
            j = np.arange(n - d)
            self.A[j, j + d] = ab[d, :n - d]
        T = bb.max_chase(n, b)
        self.Vu, self.Vv = np.zeros((n - 1, T, b)), np.zeros((n - 1, T, b))
        self.tauu, self.tauv = np.zeros((n - 1, T)), np.zeros((n - 1, T))
        self.kept = {}

    def stage(self, s, t, k):
        n, b, A = self.n, self.b, self.A
        c0 = s + 1 + t * b
        L = min(b, n - c0)
        rows = slice(s, s + 1) if t == 0 else slice(c0 - b, c0)
        nr = 1 if t == 0 else b
        cols = slice(c0, c0 + L)
        if k == 0:  # all but the late elements, read; NaN marks them
            B = A[rows, cols].copy()
            B[nr - 1, L - 1] = np.nan
            D = A[cols, cols].copy()
            D[:, L - 1] = np.nan
            self.kept[s, t] = B, D
            return
        B, D = self.kept[s, t]
        if k == 1:
            B[nr - 1, L - 1] = A[rows, cols][nr - 1, L - 1]
            D[:L - 1, L - 1] = A[c0:c0 + L - 1, c0 + L - 1]
            if t > 0:
                up, tp = self.Vu[s, t - 1], self.tauu[s, t - 1]
                B -= np.outer(tp * up, up @ B)
            v, tv, beta = larfg(B[0])
            B[1:] -= np.outer(tv * (B[1:] @ v), v)
            B[0] = 0.0
            B[0, 0] = beta
            A[rows, cols] = B
            self.Vv[s, t, :L] = v
            self.tauv[s, t] = tv
            return
        del self.kept[s, t]
        D[L - 1, L - 1] = A[c0 + L - 1, c0 + L - 1]
        v, tv = self.Vv[s, t, :L], self.tauv[s, t]
        D -= np.outer(tv * (D @ v), v)
        u, tu, beta = larfg(D[:, 0])
        D[:, 1:] -= np.outer(tu * u, u @ D[:, 1:])
        D[:, 0] = 0.0
        D[0, 0] = beta
        A[cols, cols] = D
        self.Vu[s, t, :L] = u
        self.tauu[s, t] = tu

    def result(self):
        n = self.n
        return (np.diag(self.A).copy(), self.A[np.arange(n - 1), np.arange(1, n)].copy(),
                self.Vu, self.tauu, self.Vv, self.tauv)


@pytest.mark.parametrize("chase", CHASES)
@pytest.mark.parametrize("n,b", [(12, 1), (17, 2), (40, 3), (41, 5), (30, 8), (20, 32)])
def test_interleavings_give_the_sequential_bits(chase, n, b):
    ab = np.random.default_rng(7 * n + b).standard_normal((b + 1, n))
    body = Hebr if chase == "hb2st" else Gebr
    runs = []
    for G, seed in ((1, 0), (n, 1), (3, 2), (n, 3)):
        rng = np.random.default_rng(seed)
        ch = body(ab)
        for st in run_schedule(n, b, G, lambda r: r[rng.integers(len(r))]):
            ch.stage(*st)
        runs.append(ch.result())
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert np.array_equal(x, y)
    plain = bb.hb2st if chase == "hb2st" else bb.tb2bd
    ref = [x.numpy() for x in plain(torch.from_numpy(ab))][:len(runs[0])]
    for x, y in zip(runs[0], ref):
        assert np.abs(x - y).max() <= 1e-12
