"""Multi-landscape TPE regret benchmark (the port's own copy of
``image_denoising_tpu/hpo/benchmark.py``).

On several qualitatively different objective landscapes (a smooth bowl, a
multimodal ripple, the reference's mixed int-grid/log search space of
``train_opt.py:230-231``, and a categorical/float mix) the TPE sampler of
``hpo/engine.py`` must beat pure random search on mean best-of-N regret,
with a bootstrap confidence interval of the paired difference that
excludes 0.

Run ``python -m image_denoising_tpu_torch.hpo.benchmark`` for the table.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

from .engine import TPESampler, create_study

__all__ = ["LANDSCAPES", "run_benchmark", "bootstrap_ci", "Landscape"]


@dataclass(frozen=True)
class Landscape:
    name: str
    objective: Callable  # trial -> float
    f_min: float         # known global minimum (regret reference)


def _bowl(trial):
    """Smooth anisotropic bowl over one linear + one log parameter."""
    x = trial.suggest_float("x", -5.0, 5.0)
    y = trial.suggest_loguniform("y", 1e-6, 1e-1)
    return ((x - 1.3) / 5.0) ** 2 + (np.log10(y) + 3.1) ** 2


def _multimodal(trial):
    """Rippled valley: global minimum at x=0 among ~10 local minima."""
    x = trial.suggest_float("x", -10.0, 10.0)
    return (x / 10.0) ** 2 + 0.5 * math.sin(3.0 * x) ** 2


def _reference_space(trial):
    """The reference HPO space (train_opt.py:230-231): int grid + log lr."""
    n = trial.suggest_int("n_feature", 16, 128, step=16)
    lr = trial.suggest_loguniform("lr", 1e-6, 3e-4)
    ln = np.log10(lr)
    return (
        ((n - 64) / 48.0) ** 2
        + (ln + 4.52) ** 2
        + 0.05 * np.sin(5 * ln) * np.cos(n / 7.0)
    )


def _cat_mix(trial):
    """Categorical arm choice gating a float sub-problem."""
    arm = trial.suggest_categorical("arm", ("adam", "sgd", "rmsprop"))
    x = trial.suggest_float("x", 0.0, 1.0)
    base = {"adam": 0.0, "sgd": 0.35, "rmsprop": 0.6}[arm]
    return base + (x - 0.7) ** 2


LANDSCAPES = (
    Landscape("bowl", _bowl, 0.0),
    Landscape("multimodal", _multimodal, 0.0),
    # Numerically-located minimum over the n grid × a 2M-point log10(lr)
    # sweep: f = -0.0344117 at n=64, log10 lr = -4.5893 (the sin·cos wiggle
    # shifts the optimum off the bowl's -4.52 axis).
    Landscape("reference_space", _reference_space, -0.0344117),
    Landscape("cat_mix", _cat_mix, 0.0),
)


def _random_sampler(seed: int) -> TPESampler:
    """A sampler pinned to the random-startup phase forever."""
    return TPESampler(n_startup_trials=10 ** 9, seed=seed)


def run_benchmark(n_seeds: int = 20, n_trials: int = 40,
                  landscapes=LANDSCAPES) -> Dict[str, dict]:
    """Per landscape: per-seed best-of-``n_trials`` regret for TPE vs random.

    Returns {name: {"tpe": [regret...], "random": [regret...]}}.
    """
    out: Dict[str, dict] = {}
    for ls in landscapes:
        tpe_r: List[float] = []
        rnd_r: List[float] = []
        for seed in range(n_seeds):
            s1 = create_study(f"tpe_{ls.name}_{seed}",
                              sampler=TPESampler(n_startup_trials=10, seed=seed))
            s1.optimize(ls.objective, n_trials=n_trials)
            tpe_r.append(s1.best_trial.value - ls.f_min)

            s2 = create_study(f"rnd_{ls.name}_{seed}",
                              sampler=_random_sampler(seed))
            s2.optimize(ls.objective, n_trials=n_trials)
            rnd_r.append(s2.best_trial.value - ls.f_min)
        out[ls.name] = {"tpe": tpe_r, "random": rnd_r}
    return out


def bootstrap_ci(diffs: np.ndarray, n_boot: int = 10000, alpha: float = 0.05,
                 seed: int = 0):
    """Percentile bootstrap CI for the mean of ``diffs``."""
    rng = np.random.default_rng(seed)
    means = rng.choice(diffs, size=(n_boot, len(diffs)), replace=True).mean(axis=1)
    return float(np.quantile(means, alpha / 2)), float(np.quantile(means, 1 - alpha / 2))


def main():
    res = run_benchmark()
    print(f"{'landscape':<18}{'TPE regret':>14}{'random regret':>16}"
          f"{'improvement':>13}{'95% CI of diff':>22}")
    for name, r in res.items():
        tpe = np.asarray(r["tpe"])
        rnd = np.asarray(r["random"])
        lo, hi = bootstrap_ci(rnd - tpe)
        print(f"{name:<18}{tpe.mean():>14.4f}{rnd.mean():>16.4f}"
              f"{rnd.mean() / max(tpe.mean(), 1e-12):>12.1f}x"
              f"   [{lo:+.4f}, {hi:+.4f}]")


if __name__ == "__main__":
    main()
