"""The N2N step's cell (held back from ``BENCHMARK.json``) at a tiny size on
the CPU: a sound run is correct and reports its end-to-end metrics, each
control (bf16, the mask one Philox counter off, the noise from another
seed, half of each batch) and a state left unchanged or half of each batch
left out in the timed path come out not correct, and the reference's own
Philox, mask, sub-images and noise are the program's draws."""
import time

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.kinds import n2n_step
from gpubench.reference import n2n as ref_n2n
from gpubench.reference import philox
from image_denoising_tpu_torch.ops import AugmentNoise, OperationSeed, split_seed
from image_denoising_tpu_torch.ops.neighbor import generate_mask_pair, subsample_pair

from ._tiny_cells import held_cell, tiny_cell

CELL = "n2n_f32_b4"
SEED = 2 ** 31 + 5


def test_sound_run_is_correct():
    r = harness.run_cell(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(r["checks"]) == {"grad_gap_med", "grad_gap", "step_gap"}


@pytest.mark.parametrize("control", sorted(n2n_step.CONTROLS))
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_each_control_is_not_correct(control, seed):
    cell = tiny_cell(CELL)
    assert not harness.judge(cell.limits,
                             n2n_step.control_readings(cell, seed, control, "cpu"))[0]


def test_a_state_left_unchanged_is_not_correct(monkeypatch):
    real = n2n_step.make_n2n_train_step

    def factory(net, state, **k):
        state.optimizer.step = lambda *a, **kw: None
        return real(net, state, **k)
    monkeypatch.setattr(n2n_step, "make_n2n_train_step", factory)
    r = harness.run_cell(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert r["correct"] is False and r["checks"]["step_gap"]["value"] == 1.0


def test_half_of_each_batch_left_out_is_not_correct(monkeypatch):
    real = n2n_step.make_n2n_train_step

    def factory(net, state, **k):
        step = real(net, state, **k)
        return lambda clean, noisy, seed, epoch: step(
            clean[: len(clean) // 2], noisy[: len(noisy) // 2], seed, epoch)
    monkeypatch.setattr(n2n_step, "make_n2n_train_step", factory)
    r = harness.run_cell(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert r["correct"] is False


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 64 - 1])
def test_the_reference_draws_are_the_programs(seed):
    ops = OperationSeed(seed)
    op_seeds = [ops.next() for _ in range(3)]
    assert philox.step_seeds(seed, 3) == op_seeds
    noise_seed, mask_seed = split_seed(op_seeds[1])
    assert philox.block64(op_seeds[1], 0) == (noise_seed, mask_seed)
    img = torch.rand(2, 1, 12, 16, generator=torch.Generator().manual_seed(1))
    sub1, sub2, (sel1, sel2) = subsample_pair(mask_seed, img)
    pos1, pos2 = ref_n2n.pair_positions(mask_seed, img.shape)
    assert torch.equal(pos1, sel1.long()) and torch.equal(pos2, sel2.long())
    assert torch.equal(ref_n2n.sub_image(img, pos1), sub1)
    assert torch.equal(ref_n2n.sub_image(img, pos2), sub2)
    shifted = ref_n2n.pair_positions(mask_seed, img.shape, counter_offset=1)[0]
    assert not torch.equal(shifted, pos1)
    assert torch.equal(shifted[:, 0, :-1], pos1[:, 0, 1:])  # the next cell's draw
    gen = torch.Generator()
    gen.manual_seed(noise_seed)
    want = AugmentNoise("gauss25").add_train_noise(gen, img)
    assert torch.equal(ref_n2n.noisy(img, noise_seed, 25.0), want)


def test_mask_draws_by_hand():
    """Philox4x32-10's known-answer vector (Random123 kat_vectors: counter
    and key all ones) and the draw's counter layout."""
    out = philox.philox(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 2 ** 64 - 1)
    assert [int(w) for w in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    r = philox.mask_draws(12345, 2, 6)
    assert r.shape == (2, 6) and r.min() >= 0 and r.max() <= 7
    assert int(r[1, 4]) == int(philox.philox(4, 1, 0, 0, 12345)[0]) % 8
    sel1, _ = generate_mask_pair(12345, (2, 1, 4, 6), "cpu")
    assert np.array_equal(ref_n2n.PAIRS[r][..., 0].reshape(2, 2, 3), sel1.numpy())


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card and refuses the CPU")
    r = harness.run_cell(held_cell(CELL), 2 ** 31 + 29, 3.0, False, "cuda:0", time.time())
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
