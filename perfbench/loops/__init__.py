"""The loops of the traffic mixes. A mix's file names its `kind`, the unit
family that the metrics' readers, `_spans.UNITS` and the run's `attempted`
and `failed` read: "train" (steps) or "predict" (batches). Its driver is
the loop module `perfbench/loops/<name>.py`, which reads the rest of the
file, and the check module `perfbench/checks/<name>.py`, which judges what
the loop's timed path produced; `<name>` is the mix's `loop`, or its
`kind` where the mix names none. A cell whose batch path no loop here runs
brings its loop, check, faults and reference as new files under a name of
its own, and reports its family's metrics through the readers that are
there.

A loop module gives
- `setup(cell, seeds, device, workdir, fault=None)` -> state: everything
  up to the measured window, each shape the window uses warmed up; the
  state's `batch` is the images a unit; `fault`, where given, wraps the
  timed path's call;
- `window(state, seconds, timed)` -> the measured window's counts. Train:
  `seconds` (host clock, from a synchronised start to the sync after the
  last step), `steps`, `images` (consumed), `step_ms` (ms between
  consecutive steps' end events, CUDA events recorded after each step,
  the first from an event at the window's start) and, with `timed`,
  `data_wait_s` (host s waiting on the loader) and `dispatch_s` (host s
  in the batch's copy to the device and the step's call). Predict:
  `seconds`, `images` (whose answers reached the host), `batches`,
  `batch_ms` (each batch's host ms from its call to its answer on the
  host) and `dispatched` (images sent);
- `profile(state, span)` -> the units it ran, each call into a layer
  inside `span(name)` under core/trace.py's SPANS names (`loader.next`,
  `trainer.to_device`, `step`; `inputs`, `predict`, `to_host`), so that
  the breakdown's idle gaps read alike in every cell;
- `program_outputs(state)` -> what the check judges; train: with
  `epoch_losses`, the mean loss of each epoch the loop ran, each of which
  has to be finite;
- `release(state)`: drops the program's state before the check runs;
- `FAULTS`: {mode: a wrapper of its own timed call}, where `fault` looks
  a mode up for readings.py and the tests (train.py's and predict.py's
  are perfbench/faults.py's wrappers); a mode it lacks is refused."""

import importlib

FAMILIES = ("train", "predict")


def family(mix: dict) -> str:
    """The mix's unit family; a `kind` that is neither raises."""
    kind = mix.get("kind")
    if kind not in FAMILIES:
        raise ValueError("a traffic mix's kind is a unit family, 'train' or "
                         f"'predict', not {kind!r}")
    return kind


def driver(mix: dict) -> str:
    """The name of the mix's loop and check modules."""
    return mix.get("loop", family(mix))


def loop(name: str):
    return importlib.import_module(f"perfbench.loops.{name}")


def fault(mix: dict, mode: str):
    """The wrapper that plants `mode` under the timed call of the mix's
    loop, from that loop's `FAULTS`; None where it has none."""
    return getattr(loop(driver(mix)), "FAULTS", {}).get(mode)
