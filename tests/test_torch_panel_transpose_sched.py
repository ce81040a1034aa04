"""The tiling of the panel transpose kernel K5 (csrc/panel_transpose.cu),
replayed on the host: every element is read once and written once, to
its transposed place, through the kernel's shared-memory layout.

K5 computes y_s[c][r] = x_s[r][c] for s < S, r < R, c < C, with x_s at
x + s·xb (row stride xr) and y_s at y + s·yb (row stride yr). It cuts each
segment into 64×64 tiles; tile t is (s, row block, column block), column
block fastest. A CTA of 256 threads takes tiles blockIdx, blockIdx + G
(G = ⌈tiles / 2⌉) through two shared buffers: it issues the second
tile's copies before it waits for the first's. The fill copies chunk
(rr, cc) of the tile (x's row r0 + rr, columns c0 + 4cc … + 3), chunk q =
tid + 256k, rr = q // 16, cc = q % 16, to chunk position rr·16 + (cc ^
((rr / 4) % 8)), as one 16-byte copy where x's pointer and strides are
multiples of 4 floats and the chunk lies inside C, else element by
element under the mask. The drain gives thread tid the 4×4 block r4 =
tid % 16, c4 = tid // 16: four chunk reads down rows 4r4 … 4r4 + 3, a
transpose in registers, four stores to y's rows c0 + 4c4 + j at columns
r0 + 4r4 …, as 16-byte stores where y allows and the block lies inside R.

The model replays that index map with numpy, buffer by buffer, and checks
that each (s, r, c) is read once and written once, that the value a
store writes is the x element it must be, that every 16-byte access is
16-byte aligned, and that neither the fill nor the drain has two threads
of a quarter warp on one 4-bank group of shared memory. It covers the
call shapes of the LU path (the five Pallas names, the flat branch's
whole panel both ways) and ragged, unaligned windows with S = 1 and 8.
"""

from __future__ import annotations

import numpy as np
import pytest
import tests.torch_cpu_threads  # noqa: E402,F401

TR = TC = 64            # tile rows and columns
CH = TC // 4            # 16-byte chunks in a tile row
NT = (TR // 4) * (TC // 4)   # threads: one 4×4 block each
STAGES = 2
PER_CTA = 2
FILL = TR * CH // NT    # chunks a thread copies a tile


def swz(r):
    return (r >> 2) & 7


def aligned16(p, rs, ss, S):
    """The kernel's test, in floats: pointer, row and segment strides all
    multiples of 4."""
    return p % 4 == 0 and rs % 4 == 0 and (S == 1 or ss % 4 == 0)


TID = np.arange(NT)
Q = TID[:, None] + NT * np.arange(FILL)[None]       # [NT, FILL] chunks
RR, CC = Q // CH, Q % CH
SLOT = RR * CH + (CC ^ swz(RR))                     # fill's chunk positions
R4, C4 = TID % (TR // 4), TID // (TR // 4)
DRAIN = [(4 * R4 + k) * CH + (C4 ^ (R4 & 7)) for k in range(4)]


def replay(S, R, C, x0, xr, xb, y0, yr, yb):
    """Run K5's index map; returns (reads, writes, vector reads, vector
    stores): per-element counts over the S·R·C elements (index
    s·R·C + r·C + c) and the numbers of 16-byte accesses."""
    vx, vy = aligned16(x0, xr, xb, S), aligned16(y0, yr, yb, S)
    tr, tc = -(-R // TR), -(-C // TC)
    total = S * tr * tc
    G = -(-total // PER_CTA)
    reads = np.zeros(S * R * C, np.uint8)
    writes = np.zeros(S * R * C, np.uint8)
    n_reads = n_writes = vec_reads = vec_writes = 0

    def tile_at(t):
        s, q = divmod(t, tr * tc)
        rt, ct = divmod(q, tc)
        return s, rt * TR, ct * TC

    def fill(buf, t):
        nonlocal n_reads, vec_reads
        s, r0, c0 = tile_at(t)
        r, c = r0 + RR, c0 + 4 * CC
        live = r < R
        vec = live & vx & (c + 3 < C)
        if vec.any():
            assert ((x0 + s * xb + r * xr + c)[vec] % 4 == 0).all()
        vec_reads += int(vec.sum())
        for e in range(4):
            m = live & (vec | (c + e < C))
            idx = s * R * C + r[m] * C + c[m] + e
            buf[SLOT[m], e] = idx
            reads[idx] += 1
            n_reads += idx.size

    def drain(buf, t):
        nonlocal n_writes, vec_writes
        s, r0, c0 = tile_at(t)
        v = [buf[DRAIN[k]] for k in range(4)]         # [NT, 4] each
        r = r0 + 4 * R4
        for j in range(4):
            c = c0 + 4 * C4 + j
            live = (c < C) & (r < R)
            vec = live & vy & (r + 3 < R)
            if vec.any():
                assert ((y0 + s * yb + c * yr + r)[vec] % 4 == 0).all()
            vec_writes += int(vec.sum())
            for k in range(4):
                m = live & (vec | (r + k < R))
                want = s * R * C + (r[m] + k) * C + c[m]
                # the value stored is x_s[r + k][c]
                assert np.array_equal(v[k][m, j], want)
                writes[want] += 1
                n_writes += want.size

    for b in range(G):
        buf = np.full((STAGES, TR * CH, 4), -1, np.int64)
        for p in range(STAGES - 1):                  # the prologue
            if b + p * G < total:
                fill(buf[p], b + p * G)
        for i, t in enumerate(range(b, total, G)):
            tn = t + (STAGES - 1) * G
            if tn < total:
                fill(buf[(i + STAGES - 1) % STAGES], tn)
            drain(buf[i % STAGES], t)
    assert n_reads == reads.sum() and n_writes == writes.sum()
    return reads, writes, vec_reads, vec_writes


def fold_args(S, h, w, ld, row0, off):
    """panel_fold of an [h, w] window at (row0, off) of a matrix of row
    stride ld into a new [S, w, h/S] tensor."""
    L = h // S
    return S, L, w, row0 * ld + off, ld, L * ld, 0, L, w * L


def unfold_args(S, w, L, ld, row0, off):
    """panel_unfold of a new [S, w, L] tensor into an [S·L, w] window at
    (row0, off) of a matrix of row stride ld."""
    return S, w, L, 0, L, w * L, row0 * ld + off, ld, L * ld


# (label, kernel arguments, every access 16 bytes)
CASES = [
    # the five Pallas names at their shapes on the LU path
    ("transpose_tiled [8448, 128] subpanel window",
     fold_args(1, 8448, 128, 8448, 0, 128), True),
    ("transpose_fold [16384, 128]", fold_args(8, 16384, 128, 128, 0, 0), True),
    ("fold_panel [16384, 1024] window",
     fold_args(8, 16384, 1024, 16384, 0, 0), True),
    ("unfold_panel [8, 1024, 2048] into its window",
     unfold_args(8, 1024, 2048, 16384, 0, 0), True),
    ("unfold_transpose [8, 128, 2048]", unfold_args(8, 128, 2048, 128, 0, 0),
     True),
    # the flat branch's whole panel of gesv 8448, there and back into the
    # window of a later group (rows from 1024, columns from 1280)
    ("transpose_tiled [7424, 256] window",
     fold_args(1, 7424, 256, 8448, 1024, 1280), True),
    ("transpose_tiled [256, 7424] into its window",
     (1, 256, 7424, 0, 7424, 0, 1024 * 8448 + 1280, 8448, 0), True),
    # ragged and unaligned windows, S = 1 and 8
    ("[130, 77] at column 17", fold_args(1, 130, 77, 134, 3, 17), False),
    ("[8·37, 50] at column 16", fold_args(8, 8 * 37, 50, 90, 3, 16), False),
    ("[8, 50, 37] into a window at column 17",
     unfold_args(8, 50, 37, 107, 3, 17), False),
    ("[1024, 256] at column 4", fold_args(8, 1024, 256, 300, 3, 4), True),
    ("[135, 66] at column 2", fold_args(1, 135, 66, 110, 3, 2), False),
    ("[1, 66, 135] into a window at column 2",
     unfold_args(1, 66, 135, 110, 3, 2), False),
]


@pytest.mark.parametrize("label,args,vector", CASES,
                         ids=[c[0] for c in CASES])
def test_each_element_read_and_written_once(label, args, vector):
    S, R, C, x0, xr, xb, y0, yr, yb = args
    reads, writes, vec_reads, vec_writes = replay(*args)
    assert (reads == 1).all() and (writes == 1).all()
    if vector:
        # where every chunk and block is whole, every access is 16 bytes
        assert R % 4 == 0 and C % 4 == 0
        assert vec_reads * 4 == S * R * C and vec_writes * 4 == S * R * C
    else:
        assert vec_reads * 4 < S * R * C or vec_writes * 4 < S * R * C


def test_unaligned_windows_take_the_masked_path():
    """An odd column offset makes every read element-wise (no 16-byte copy
    from an address that is not 16-byte aligned), while the stores of an
    aligned result stay 16 bytes."""
    args = fold_args(1, 256, 128, 300, 0, 1)
    reads, writes, vec_reads, vec_writes = replay(*args)
    assert (reads == 1).all() and (writes == 1).all()
    assert vec_reads == 0 and vec_writes * 4 == 256 * 128


def test_shared_memory_has_no_bank_conflicts():
    """A 16-byte shared access of a quarter warp (8 threads) is served in
    one pass when the 8 chunks fall in 8 distinct 4-bank groups
    (position mod 8): so for the fill's chunk writes and the drain's
    chunk reads."""
    for k in range(FILL):
        for q0 in range(0, NT, 8):
            assert len(set(SLOT[q0:q0 + 8, k] % 8)) == 8
    for k in range(4):
        for q0 in range(0, NT, 8):
            assert len(set(DRAIN[k][q0:q0 + 8] % 8)) == 8


def test_model_matches_the_source():
    """The constants and the two index maps the model replays are the
    kernel's."""
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent
           / "slate_tpu_torch/csrc/panel_transpose.cu").read_text()
    for line in (f"constexpr int TR = {TR};", f"constexpr int TC = {TC};",
                 f"constexpr int STAGES = {STAGES};",
                 f"constexpr int PER_CTA = {PER_CTA};",
                 "return (r >> 2) & 7;",
                 "float4* dst = b + rr * CH + (cc ^ swz(rr));",
                 "v[k] = b[(4 * r4 + k) * CH + (c4 ^ (r4 & 7))];",
                 "const int r4 = threadIdx.x % (TR / 4), "
                 "c4 = threadIdx.x / (TR / 4);"):
        assert line in src, line
