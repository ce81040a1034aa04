"""One PyTorch intra-op thread for the port's CPU tests.

The tier-1 run puts six xdist workers on eight cores, and torch's default
of one intra-op thread a core then oversubscribes them. The port's plain
kernel versions are loops of small tensor ops, whose time goes to waking
those threads: on an eight-core host ``getrf`` at n = 2048, nb = 1024 on
the CPU takes 33.9 s with eight threads and 2.0 s with one. Each port
test module imports this one, so any selection of them runs the same
way; the setting holds for the whole test process."""

import torch

torch.set_num_threads(1)
