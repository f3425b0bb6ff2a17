"""Learning-rate schedules (the port's copy of ``image_denoising_tpu/train/schedule.py``).

``multistep_lr`` reproduces torch MultiStepLR stepped once per epoch: during
epoch e (1-based), the scheduler has been stepped e−1 times, so
lr = lr0 · γ^|{m ∈ milestones : m ≤ e−1}|.

``reference_milestones`` is the A-domain trainer's schedule
(``train.py:330-340``): milestones at int(p·ratio)−1 for p ∈ {20,40,60,80}
with ratio = n_epoch/100.
"""
from __future__ import annotations

from typing import Sequence

__all__ = ["multistep_lr", "reference_milestones", "hpo_milestones"]


def reference_milestones(n_epoch: int) -> list[int]:
    ratio = n_epoch / 100
    return [int(20 * ratio) - 1, int(40 * ratio) - 1, int(60 * ratio) - 1,
            int(80 * ratio) - 1]


def hpo_milestones(tune_epochs: int) -> list[int]:
    """train_opt.py:254-257 — {0.5, 0.75}·tune_epochs, strictly increasing, < total."""
    m1 = max(1, int(round(0.5 * tune_epochs)))
    m2 = max(m1 + 1, int(round(0.75 * tune_epochs)))
    return [m for m in (m1, m2) if m < tune_epochs]


def multistep_lr(lr0: float, milestones: Sequence[int], gamma: float, epoch: int) -> float:
    """LR in effect during 1-based ``epoch`` with per-epoch stepping."""
    steps_taken = epoch - 1
    # torch applies a decay whenever its step counter hits a milestone value;
    # the counter starts at 0, so milestone 0 decays immediately and negative
    # milestones never fire (relevant for tiny n_epoch where int(p·ratio)−1<1).
    n_decays = sum(1 for m in milestones if 0 <= m <= steps_taken)
    return lr0 * (gamma ** n_decays)
