"""Every random stream of a run, derived from its one `--seed`, which may be
any whole number (numpy's RandomState takes only 32 bits)."""

from __future__ import annotations

import numpy as np

STREAMS = ("data", "weights", "program", "traffic", "sample")


def derive(seed: int) -> dict:
    """{stream: a 31-bit seed} for each of STREAMS, a function of `seed`."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(
        len(STREAMS))
    return {k: int(w) & 0x7FFFFFFF for k, w in zip(STREAMS, words)}
