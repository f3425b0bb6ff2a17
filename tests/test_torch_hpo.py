"""The port's HPO engine (hpo/engine.py) and regret benchmark
(hpo/benchmark.py) against the JAX package's: the same seed and the same
history give the same suggestions, draw for draw, for every kind of
distribution; and the engine's own behaviour (TPE convergence, bounds,
SQLite persistence and resume, callbacks, thread-parallel trials)."""
import json
import math
import os
import threading

import numpy as np
import pytest

from image_denoising_tpu.hpo import benchmark as jax_benchmark
from image_denoising_tpu.hpo import engine as jax_engine
from image_denoising_tpu_torch.hpo import benchmark, create_study, engine
from image_denoising_tpu_torch.hpo.engine import TPESampler


def _objective(kinds):
    """A deterministic numpy objective over the parameters ``kinds`` names."""

    def objective(trial):
        value = 0.0
        if "float" in kinds:
            x = trial.suggest_float("x", -5.0, 5.0)
            value += ((x - 1.3) / 5.0) ** 2
        if "logfloat" in kinds:
            lr = trial.suggest_loguniform("lr", 1e-6, 3e-4)
            value += (np.log10(lr) + 4.5) ** 2
        if "int" in kinds:
            n = trial.suggest_int("n_feature", 16, 128, step=16)
            value += ((n - 64) / 48.0) ** 2 + 0.05 * math.sin(n / 7.0)
        if "categorical" in kinds:
            arm = trial.suggest_categorical("arm", ("adam", "sgd", "rmsprop"))
            value += {"adam": 0.0, "sgd": 0.35, "rmsprop": 0.6}[arm]
        return value

    return objective


@pytest.mark.parametrize("kinds", [("float",), ("logfloat",), ("int",), ("categorical",),
                                   ("float", "logfloat", "int", "categorical")])
@pytest.mark.parametrize("seed", [0, 11])
def test_engine_suggests_as_jax_draw_for_draw(kinds, seed):
    """40 trials, past the 10 random start-up draws: every trial's params,
    every value and the best trial are identical."""
    studies = []
    for mod in (engine, jax_engine):
        study = mod.create_study("parity", sampler=mod.TPESampler(n_startup_trials=10,
                                                                  seed=seed))
        study.optimize(_objective(kinds), n_trials=40)
        studies.append(study)
    port, ref = studies
    assert [t.params for t in port.trials] == [t.params for t in ref.trials]
    assert [t.value for t in port.trials] == [t.value for t in ref.trials]
    assert port.best_trial.number == ref.best_trial.number
    assert port.best_params == ref.best_params


def test_engine_continues_a_jax_history():
    """The same history, given to both samplers, gives the same next draw
    for each kind of distribution (an int with a step, log and linear
    floats, a categorical)."""
    rng = np.random.default_rng(99)
    dists = [("_IntDist", (16, 128, 16)), ("_FloatDist", (1e-6, 3e-4, True)),
             ("_FloatDist", (-5.0, 5.0, False)), ("_CatDist", (("adam", "sgd", "rmsprop"),))]
    for name, args in dists:
        samples = {"_IntDist": lambda: int(rng.choice(range(16, 129, 16))),
                   "_FloatDist": lambda: float(rng.uniform(*args[:2])),
                   "_CatDist": lambda: str(rng.choice(args[0]))}[name]
        history = [(samples(), float(rng.random())) for _ in range(30)]
        for seed in (0, 7):
            got = TPESampler(n_startup_trials=4, seed=seed).sample(
                getattr(engine, name)(*args), history)
            want = jax_engine.TPESampler(n_startup_trials=4, seed=seed).sample(
                getattr(jax_engine, name)(*args), history)
            assert got == want and type(got) is type(want), (name, seed)


def test_benchmark_equals_jax():
    got = benchmark.run_benchmark(n_seeds=2, n_trials=14)
    want = jax_benchmark.run_benchmark(n_seeds=2, n_trials=14)
    assert got == want
    assert [ls.name for ls in benchmark.LANDSCAPES] == [ls.name for ls in jax_benchmark.LANDSCAPES]
    diffs = np.asarray(want["bowl"]["random"]) - np.asarray(want["bowl"]["tpe"])
    assert benchmark.bootstrap_ci(diffs, n_boot=200) == jax_benchmark.bootstrap_ci(diffs,
                                                                                   n_boot=200)


def test_random_then_tpe_converges():
    """TPE concentrates samples near the optimum of a quadratic."""
    study = create_study("t", sampler=TPESampler(n_startup_trials=8, seed=0))

    def objective(trial):
        x = trial.suggest_float("x", -5.0, 5.0)
        return (x - 2.0) ** 2

    study.optimize(objective, n_trials=60)
    assert abs(study.best_params["x"] - 2.0) < 0.5
    late = [t.params["x"] for t in study.trials[40:]]
    assert abs(np.median(late) - 2.0) < 1.5


def test_int_grid_and_loguniform_bounds():
    study = create_study("t2", sampler=TPESampler(n_startup_trials=2, seed=1))

    def objective(trial):
        n = trial.suggest_int("n_feature", 16, 128, step=16)
        lr = trial.suggest_loguniform("lr", 1e-6, 3e-4)
        assert n in range(16, 129, 16)
        assert 1e-6 <= lr <= 3e-4
        return abs(n - 64) + abs(np.log10(lr) + 4)

    study.optimize(objective, n_trials=20)
    assert study.best_trial.value is not None


def test_sqlite_persistence_and_resume(tmp_path):
    db = f"sqlite:///{tmp_path}/study.db"
    study = create_study("persist", storage=db)

    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        trial.set_user_attr("init_seed", 42 + trial.number)
        return x

    study.optimize(objective, n_trials=5)
    assert os.path.exists(str(tmp_path / "study.db"))

    study2 = create_study("persist", storage=db, load_if_exists=True)
    assert len(study2.trials) == 5
    assert study2.best_trial.user_attrs["init_seed"] >= 42
    study2.optimize(objective, n_trials=3)
    assert len(study2.trials) == 8
    assert len(create_study("persist", storage=db).trials) == 8
    # load_if_exists=False starts the storage afresh
    assert len(create_study("persist", storage=db, load_if_exists=False).trials) == 0


def test_storage_reads_a_jax_study(tmp_path):
    """One SQLite file serves both packages: a study the JAX engine wrote
    resumes in the port with the same trials and the same next draw."""
    db = f"sqlite:///{tmp_path}/shared.db"
    ref = jax_engine.create_study("shared", storage=db)
    ref.optimize(_objective(("float", "int")), n_trials=12)
    port = create_study("shared", storage=db)
    assert [(t.number, t.params, t.value) for t in port.trials] == \
        [(t.number, t.params, t.value) for t in ref.trials]
    assert port.best_trial.number == ref.best_trial.number


def test_callbacks_jsonl(tmp_path):
    study = create_study("cb")
    log = tmp_path / "trials.log"

    def cb(study, trial):
        with open(log, "a") as f:
            f.write(json.dumps({"trial": trial.number, "value": trial.value}) + "\n")

    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=4, callbacks=[cb])
    lines = open(log).read().strip().split("\n")
    assert [json.loads(line)["trial"] for line in lines] == [0, 1, 2, 3]


def test_thread_parallel_trials(tmp_path):
    """n_jobs=2 runs trials on worker threads; no trial is lost, in memory
    or in storage."""
    db = f"sqlite:///{tmp_path}/par.db"
    study = create_study("par", storage=db)
    seen_threads = set()
    both_running = threading.Barrier(2, timeout=10)

    def objective(trial):
        seen_threads.add(threading.get_ident())
        if trial.number < 2:
            both_running.wait()  # the first two trials overlap
        return trial.suggest_float("x", 0.0, 1.0)

    study.optimize(objective, n_trials=6, n_jobs=2)
    assert sorted(t.number for t in study.trials) == list(range(6))
    assert all(t.value is not None for t in study.trials)
    assert len(seen_threads) >= 2
    assert sorted(t.number for t in create_study("par", storage=db).trials) == list(range(6))


def test_thread_parallel_sampler_stress(tmp_path):
    """n_jobs=4 with a small start-up, so most draws take the TPE path
    against a history that grows concurrently: no duplicate trial numbers,
    every draw in bounds and on the grid, storage consistent."""
    db = f"sqlite:///{tmp_path}/stress.db"
    study = create_study("stress", storage=db, sampler=TPESampler(n_startup_trials=4, seed=2))

    def objective(trial):
        n = trial.suggest_int("n_feature", 16, 128, step=16)
        lr = trial.suggest_loguniform("lr", 1e-6, 3e-4)
        opt = trial.suggest_categorical("opt", ("adam", "sgd"))
        assert n in range(16, 129, 16) and 1e-6 <= lr <= 3e-4 and opt in ("adam", "sgd")
        return ((n - 64) / 48.0) ** 2 + (np.log10(lr) + 4.5) ** 2

    study.optimize(objective, n_trials=24, n_jobs=4)
    assert sorted(t.number for t in study.trials) == list(range(24))
    assert all(t.value is not None and np.isfinite(t.value) for t in study.trials)
    assert {t.number for t in create_study("stress", storage=db).trials} == set(range(24))


def test_tpe_categorical_choices():
    """String and non-0..n-1 numeric categoricals sample past start-up."""
    s = TPESampler(n_startup_trials=2, seed=0)
    hist_str = [("adam", 0.1), ("sgd", 0.9), ("adam", 0.2), ("adam", 0.15)]
    picks = [s.sample(engine._CatDist(("adam", "sgd")), hist_str) for _ in range(40)]
    assert set(picks) <= {"adam", "sgd"}
    assert picks.count("adam") > picks.count("sgd")
    hist_num = [(32, 0.1), (16, 0.9), (32, 0.2), (32, 0.15)]
    picks = [s.sample(engine._CatDist((16, 32)), hist_num) for _ in range(40)]
    assert set(picks) <= {16, 32}
    assert picks.count(32) > picks.count(16)


def test_tpe_beats_random_on_reference_space():
    """Past start-up, the TPE's median objective on the reference search
    space sits well below random search's, and every seed's best lands in
    the basin of the known optimum (n_feature 64, log10 lr −4.5893)."""
    objective = benchmark._reference_space
    tpe_late, rnd_late = [], []
    for seed in range(3):
        s1 = create_study(f"tpe{seed}", sampler=TPESampler(n_startup_trials=10, seed=seed))
        s1.optimize(objective, n_trials=40)
        tpe_late += [t.value for t in s1.trials[10:]]
        best = s1.best_trial
        assert best.value < 0.05, (seed, best.value)
        assert abs(best.params["n_feature"] - 64) <= 16, (seed, best.params)
        assert abs(np.log10(best.params["lr"]) + 4.5893) < 0.3, (seed, best.params)
        s2 = create_study(f"rnd{seed}", sampler=TPESampler(n_startup_trials=10 ** 9, seed=seed))
        s2.optimize(objective, n_trials=40)
        rnd_late += [t.value for t in s2.trials[10:]]
    assert np.median(tpe_late) < 0.6 * np.median(rnd_late)
