"""Each cell's control, the reference put in the program's place one
precision below the configuration's, comes out not correct under the
cell's limits, at a size the CPU holds; the faults a training cell can
have that need no program run read as the comparison says."""
import pytest

from gpubench import calibrate, check, harness

from ._tiny import tiny_cell


@pytest.mark.parametrize("workload,precision", [
    ("e2_bf16_burst8", "fp8"), ("e2_f32_burst8", "tf32")])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_serving_control_is_not_correct(workload, precision, seed):
    cell = tiny_cell(workload)
    readings = calibrate.serving_control(cell, seed, precision, "cpu")
    assert not harness.judge(cell.limits, readings)[0]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_training_control_and_half_batch_are_not_correct(seed):
    cell = tiny_cell("train_structure_f32_b4")
    got = calibrate.training_controls(cell, seed, "bfloat16", "cpu")
    assert not harness.judge(cell.limits, got["bfloat16"])[0]
    assert not harness.judge(cell.limits, got["half_batch"])[0]


def test_a_state_left_unchanged_reads_one():
    ref = ([0.3, 0.29, 0.28], [1.0, 2.0, 3.0, 4.0], [0.1, 0.2, 0.3, 0.4])
    prog = (ref[0], [0.0] * 4, [0.0] * 4)
    r = check.train_readings(prog, ref)
    assert r["grad_gap"] == r["step_gap"] == 1.0 and r["grad_gap_med"] >= 0.5
    assert not harness.judge(harness.load_cell("train_structure_f32_b4").limits, r)[0]
