"""The exchange of the panel QR kernel K6 (csrc/panel_qr.cu), modelled on
the host: no reader takes a word of an earlier column or launch.

Per column c, each of the G CTAs of a launch publishes its partial sums,
one word per column k ≥ c, tagged (epoch << 8) | (c + 1), into slot c % 2
of the scratch; the owner of row c publishes that row into the row slot
c % 2 (during its pass of column c − 1, or before column 0). The owner of
column k (CTA k mod G) waits for the G words of k, sums them and publishes
s_k into the sum slot c % 2; then every CTA waits for every s_k (k ≥ c)
and the row of column c, and goes on with its pass, after which it
publishes column c + 1's words. A word whose tag is not yet there is read
again; there is no barrier across CTAs. The scratch is kept from launch to
launch on a stream: each launch takes the next epoch, and the scratch is
zeroed before the epoch wraps (``kernels._qr_scratch``). Launches on one
stream run one after the other.

The model runs the CTAs' steps in random interleavings over a sequence of
launches (G, the row split and the column count varying, the epoch
wrapping), records in every slot which launch, column and CTA wrote it,
and checks that each read that the tag admits returns the word of its own
launch and column, and that the CTAs always finish (no reader waits for a
word that an overwrite has made unreachable).
"""

from __future__ import annotations

import numpy as np
import pytest
import tests.torch_cpu_threads  # noqa: E402,F401


def tag(epoch, c):
    return (epoch << 8) | (c + 1)


def cta_program(g, G, jn, R):
    """CTA g's steps for one launch: ('row', c) publishes row c, ('word',
    c, k) its partial of column k for column c, ('read', c, q, k) waits
    for CTA q's, ('sum', c, k) publishes s_k, ('sread', c, k) waits for
    it, ('hread', c) for the row of column c."""
    prog = []

    def publish(c):
        if c // R == g:
            prog.append(("row", c))
        prog.extend(("word", c, k) for k in range(c, jn))
    publish(0)
    for c in range(jn):
        mine = [k for k in range(c, jn) if k % G == g]
        prog.extend(("read", c, q, k) for k in mine for q in range(G))
        prog.extend(("sum", c, k) for k in mine)
        prog.extend(("sread", c, k) for k in range(c, jn))
        prog.append(("hread", c))
        if c + 1 < jn:
            publish(c + 1)
    return prog


def run_launch(mem, launch, epoch, G, jn, R, rng):
    """One launch on the scratch ``mem`` (slot → (tag, identity)); raises
    on a deadlock or a wrong read."""
    progs = [cta_program(g, G, jn, R) for g in range(G)]
    pos = [0] * G
    while True:
        live = [g for g in range(G) if pos[g] < len(progs[g])]
        if not live:
            return
        ready = []
        for g in live:
            st = progs[g][pos[g]]
            if st[0] == "read":
                key = ("part", st[1] % 2, st[2], st[3])
            elif st[0] == "sread":
                key = ("sum", st[1] % 2, st[2])
            elif st[0] == "hread":
                key = ("row", st[1] % 2)
            else:
                ready.append(g)
                continue
            if mem.get(key, (0,))[0] == tag(epoch, st[1]):
                ready.append(g)
        assert ready, f"deadlock in launch {launch}"
        g = ready[rng.integers(len(ready))]
        st = progs[g][pos[g]]
        pos[g] += 1
        kind, c = st[0], st[1]
        if kind == "word":
            mem["part", c % 2, g, st[2]] = (tag(epoch, c), (launch, c))
        elif kind == "sum":
            mem["sum", c % 2, st[2]] = (tag(epoch, c), (launch, c))
        elif kind == "row":
            mem["row", c % 2] = (tag(epoch, c), (launch, c))
        elif kind == "read":
            assert mem["part", c % 2, st[2], st[3]][1] == (launch, c)
        elif kind == "sread":
            assert mem["sum", c % 2, st[2]][1] == (launch, c)
        else:
            assert mem["row", c % 2][1] == (launch, c)


@pytest.mark.parametrize("epochs", [2, 3, (1 << 24) - 1])
@pytest.mark.parametrize("seed", range(4))
def test_no_reader_takes_a_word_of_an_earlier_column_or_launch(epochs, seed):
    rng = np.random.default_rng(seed)
    mem: dict = {}
    epoch = 0
    for launch in range(24):
        if epoch >= epochs:          # the wrapper zeroes before the wrap
            mem.clear()
            epoch = 0
        epoch += 1
        G = int(rng.integers(1, 6))
        jn = int(rng.integers(1, 4 if launch % 2 else 9))
        R = int(rng.integers(1, 4))   # rows a CTA holds: the row owners
        run_launch(mem, launch, epoch, G, jn, max(R, -(-jn // G)), rng)
