"""The general loops of the traffic mixes: a mix's file names its `kind`,
and the loop module of that kind reads the rest of the file.

Each loop module gives `setup(cell, seeds, device, workdir, fault=None)`
-> state, `window(state, seconds, timed)` -> counts,
`profile(state, span)` -> the number of units profiled, `program_outputs
(state)` -> what the check judges, and `release(state)`."""

import importlib


def loop(kind: str):
    return importlib.import_module(f"perfbench.loops.{kind}")
