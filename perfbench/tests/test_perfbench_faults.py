"""`correct` on the CPU at a tiny size: a sound float32 run passes the
cells' limits, each fault planted under a train step comes out not
correct, and so does the control (the reference in float8 in the
program's place) of the train cells. The eval cells' limits are set for
512x512 tiles, whose widest gap spans many more pixels: at the tiny size
the control's and an altered answer's widest gaps are held to read over
three times the bfloat16 program's instead. The card's readings, at the cells' sizes, are in
PERF.md."""

import pytest

from perfbench import faults, loops
from perfbench.tests import tiny

TRAIN = ["unet64_mc.train", "transunet_r50_b16.train"]
EVAL = ["unet64_mc.eval", "transunet_r50_b16.eval"]


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_a_sound_run_is_correct(name):
    result, checks, _ = tiny.run(tiny.cell(name))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_is_not_correct(name):
    result, checks, _ = tiny.run(tiny.cell(name, "bf16"), control="fp8")
    assert not result["correct"], checks


@pytest.mark.parametrize("name", EVAL)
def test_the_control_reads_apart_from_the_program(name):
    _, _, program = tiny.run(tiny.cell(name, "bf16"))
    _, _, control = tiny.run(tiny.cell(name, "bf16"), control="fp8")
    assert control["class_gap"] > 3 * program["class_gap"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_step_is_not_correct(name, fault):
    c = tiny.cell(name)
    result, checks, _ = tiny.run(c, fault=loops.fault(c["traffic_spec"],
                                                      fault))
    assert not result["correct"], checks


@pytest.mark.parametrize("name", EVAL)
def test_an_altered_answer_reads_apart_from_the_program(name):
    _, _, program = tiny.run(tiny.cell(name, "bf16"))
    _, _, altered = tiny.run(tiny.cell(name, "bf16"), fault=faults.altered)
    assert altered["class_gap"] > 3 * program["class_gap"] > 0


def test_an_altered_answer_is_not_correct():
    result, checks, _ = tiny.run(tiny.cell("unet64_mc.eval"),
                                 fault=faults.altered)
    assert not result["correct"], checks
