"""Hyper-parameter-optimization engine (the port's own copy of
``image_denoising_tpu/hpo/engine.py``, an Optuna-compatible subset).

The reference delegates HPO to Optuna with SQLite storage
(``train_opt.py:282-294``); neither package depends on Optuna. The engine
is numpy, scipy and the standard library, and gives the same suggestions
as the JAX package's draw for draw: the same seed and the same history
give the same params. Its working surface:

* ``create_study(study_name, storage, load_if_exists, direction)``:
  SQLite-backed (``sqlite:///...`` URLs), resumable across interruptions;
* ``Trial.suggest_int(name, lo, hi, step)`` / ``suggest_loguniform`` /
  ``suggest_float`` / ``suggest_uniform`` / ``suggest_categorical``;
* trial ``user_attrs`` (init seeds, device ids, weight snapshots);
* ``study.optimize(objective, n_trials, n_jobs, callbacks)``,
  ``study.best_trial`` / ``best_params``.

Sampler: an independent Tree-structured Parzen Estimator per parameter,
Optuna's documented default univariate TPE (Bergstra et al. 2011 with
Optuna's defaults): after ``n_startup_trials`` random draws, observations
split by the γ rule min(⌈0.1·n⌉, 25) into below/above sets; each set
becomes a weighted Parzen mixture with a domain-wide Gaussian prior
component, neighbor-distance bandwidths under the "magic clip"
σ ∈ [(high−low)/min(100, 1+n), high−low], and linear-forgetting weights
(oldest trials ramp from 1/n once more than 25 observations exist); 24
candidates are drawn from the below mixture (truncated normals on the
domain) and the one maximizing the expected-improvement proxy
log l(x) − log g(x) wins. Int parameters are discretized-continuous
(±step/2 domain extension, per-bin CDF mass); log parameters fit in log
space.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import sqlite3
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = ["Trial", "Study", "create_study", "TPESampler"]


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _IntDist:
    low: int
    high: int
    step: int = 1

    def grid(self):
        return np.arange(self.low, self.high + 1, self.step)


@dataclass(frozen=True)
class _FloatDist:
    low: float
    high: float
    log: bool = False


@dataclass(frozen=True)
class _CatDist:
    choices: tuple


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _default_gamma(n: int) -> int:
    """Optuna's default below-set size: min(⌈0.1·n⌉, 25)."""
    return min(int(math.ceil(0.1 * n)), 25)


def _default_weights(n: int) -> np.ndarray:
    """Optuna's linear-forgetting weights over trial-ordered observations:
    uniform up to 25; beyond that the oldest n−25 ramp linearly from 1/n
    to 1 and the newest 25 stay at 1."""
    if n == 0:
        return np.asarray([])
    if n < 25:
        return np.ones(n)
    ramp = np.linspace(1.0 / n, 1.0, num=n - 25)
    return np.concatenate([ramp, np.ones(25)])


def _ndtr(z):
    """Standard normal CDF (scipy.special.ndtr, kept local for clarity)."""
    from scipy.special import ndtr

    return ndtr(z)


class _ParzenEstimator:
    """Weighted 1-D Gaussian-mixture density over a bounded domain —
    Optuna's univariate Parzen estimator:

    * one component per observation (internal space: log for log dists,
      ±step/2-extended continuous domain for int dists),
    * a PRIOR component: N(midpoint, high−low) with ``prior_weight``
      (omitted when ``consider_prior=False``, unless there are no
      observations — the mixture must stay non-empty),
    * bandwidths = max distance to the sorted neighbors (domain endpoints
      as sentinels), under the "magic clip"
      σ ∈ [(high−low)/min(100, 1+n_components), high−low],
    * components truncated to [low, high]; int (quantized) dists score a
      value by its bin's CDF mass.

    ``mus`` must be in trial order; ``weights`` (same order, un-normalized)
    carry the linear forgetting. The prior keeps sampling exploratory and
    g(x) strictly positive even when the above set is empty.
    """

    def __init__(self, mus, low, high, weights, prior_weight: float = 1.0,
                 q: Optional[float] = None, consider_prior: bool = True):
        mus = np.asarray(mus, dtype=float)
        weights = np.asarray(weights, dtype=float)
        assert mus.shape == weights.shape
        self.low, self.high, self.q = float(low), float(high), q
        n = len(mus)
        order = np.argsort(mus, kind="stable")
        sorted_mus = mus[order]
        # Optuna omits the prior component under consider_prior=False but
        # forces it when there are no observations (the mixture must be
        # non-empty for g(x) > 0).
        use_prior = consider_prior or n == 0
        if use_prior:
            prior_mu = 0.5 * (low + high)
            prior_sigma = high - low
            prior_pos = int(np.searchsorted(sorted_mus, prior_mu))
            all_mus = np.insert(sorted_mus, prior_pos, prior_mu)
        else:
            all_mus = sorted_mus
        # neighbor-distance bandwidths with the domain endpoints as sentinels
        with_endpoints = np.concatenate([[low], all_mus, [high]])
        sigmas = np.maximum(with_endpoints[1:-1] - with_endpoints[:-2],
                            with_endpoints[2:] - with_endpoints[1:-1])
        # magic clip
        max_sigma = high - low
        min_sigma = max_sigma / min(100.0, 1.0 + len(all_mus))
        sigmas = np.clip(sigmas, min_sigma, max_sigma)
        if use_prior:
            sigmas[prior_pos] = prior_sigma  # prior keeps its wide bandwidth
            all_weights = np.insert(weights[order], prior_pos, prior_weight)
        else:
            all_weights = weights[order]
        self.mus = all_mus
        self.sigmas = np.maximum(sigmas, 1e-12)
        self.weights = all_weights / all_weights.sum()
        # per-component truncation mass over [low, high]
        self._trunc = np.maximum(
            _ndtr((high - self.mus) / self.sigmas)
            - _ndtr((low - self.mus) / self.sigmas),
            1e-300,
        )

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n draws from the truncated mixture (inverse-CDF per component)."""
        from scipy.special import ndtri

        ks = rng.choice(len(self.mus), size=n, p=self.weights)
        mu, sig = self.mus[ks], self.sigmas[ks]
        lo_cdf = _ndtr((self.low - mu) / sig)
        hi_cdf = _ndtr((self.high - mu) / sig)
        u = rng.uniform(lo_cdf, hi_cdf)
        x = mu + sig * ndtri(np.clip(u, 1e-12, 1 - 1e-12))
        return np.clip(x, self.low, self.high)

    def log_pdf(self, xs: np.ndarray) -> np.ndarray:
        xs = np.asarray(xs, dtype=float)
        if self.q is None:
            z = (xs[:, None] - self.mus[None, :]) / self.sigmas[None, :]
            comp = (np.exp(-0.5 * z * z)
                    / (np.sqrt(2 * np.pi) * self.sigmas[None, :])
                    / self._trunc[None, :])
        else:
            # quantized: each value owns the CDF mass of its ±q/2 bin
            ub = np.minimum(xs + 0.5 * self.q, self.high)
            lb = np.maximum(xs - 0.5 * self.q, self.low)
            comp = (_ndtr((ub[:, None] - self.mus[None, :]) / self.sigmas[None, :])
                    - _ndtr((lb[:, None] - self.mus[None, :]) / self.sigmas[None, :]))
            comp = np.maximum(comp, 0.0) / self._trunc[None, :]
        return np.log(np.maximum(comp @ self.weights, 1e-300))


class TPESampler:
    """Optuna-default univariate TPE (see module docstring).

    ``gamma``: None → Optuna's min(⌈0.1·n⌉, 25); a float γ → the legacy
    fractional split ⌈γ·n⌉ (kept for callers pinning the old behavior);
    a callable n→int is used as-is. ``n_candidates`` is Optuna's
    ``n_ei_candidates``. ``prior_weight``/``consider_prior`` control the
    domain-wide prior component.
    """

    def __init__(self, n_startup_trials: int = 10, n_candidates: int = 24,
                 gamma=None, seed: int = 0, prior_weight: float = 1.0,
                 consider_prior: bool = True):
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        if gamma is None:
            self.gamma = _default_gamma
        elif callable(gamma):
            self.gamma = gamma
        else:
            frac = float(gamma)
            self.gamma = lambda n: max(1, int(math.ceil(frac * n)))
        self.prior_weight = prior_weight
        self.consider_prior = consider_prior
        self.rng = np.random.default_rng(seed)
        # np.random.Generator is NOT thread-safe; Study.optimize(n_jobs>1)
        # calls sample() from concurrent trial threads (the reference keeps
        # per-trial RNG isolated via fork_rng, train_opt.py:236-239 — this is
        # the equivalent care for the shared sampler state). RLock because
        # sample() falls through to _random() during startup.
        self._rng_lock = threading.RLock()

    # --- random draws ---
    def _random(self, dist):
        with self._rng_lock:
            return self._random_locked(dist)

    def _random_locked(self, dist):
        if isinstance(dist, _IntDist):
            return int(self.rng.choice(dist.grid()))
        if isinstance(dist, _FloatDist):
            if dist.log:
                # exp(log(high)) can land 1 ULP outside the bound — clamp
                # back to the domain (optuna clips float suggestions too)
                v = float(np.exp(self.rng.uniform(np.log(dist.low),
                                                  np.log(dist.high))))
                return min(max(v, dist.low), dist.high)
            return float(self.rng.uniform(dist.low, dist.high))
        if isinstance(dist, _CatDist):
            return dist.choices[int(self.rng.integers(len(dist.choices)))]
        raise TypeError(dist)

    # --- TPE ---
    def sample(self, dist, history: List[tuple]):
        """history: [(value_of_param, objective_value), ...] completed only,
        in trial order (the forgetting weights key on recency)."""
        with self._rng_lock:
            return self._sample_locked(dist, history)

    def _split(self, obs):
        """Below/above split: the ⌈γ⌉ best by objective form 'below'; both
        groups keep TRIAL order (linear forgetting weights recency)."""
        n_below = self.gamma(len(obs))
        order = np.argsort([y for _, y in obs], kind="stable")
        below_idx = np.sort(order[:n_below])
        above_idx = np.sort(order[n_below:])
        below = [obs[i][0] for i in below_idx]
        above = [obs[i][0] for i in above_idx]
        return below, above

    def _sample_locked(self, dist, history: List[tuple]):
        obs = [(x, y) for x, y in history if y is not None and np.isfinite(y)]
        if len(obs) < self.n_startup_trials:
            return self._random(dist)
        below, above = self._split(obs)
        # categorical smoothing: Optuna's prior pseudo-count; under
        # consider_prior=False keep an epsilon so unseen categories score
        # log(~0) rather than crashing log(0)
        cat_prior = self.prior_weight if self.consider_prior else 1e-12

        if isinstance(dist, _CatDist):
            # weighted category counts + the prior's uniform smoothing
            def cat_probs(vals):
                w = _default_weights(len(vals))
                counts = np.full(len(dist.choices), cat_prior, dtype=float)
                for wi, v in zip(w, vals):
                    counts[dist.choices.index(v)] += wi
                return counts / counts.sum()

            p_below, p_above = cat_probs(below), cat_probs(above)
            ks = self.rng.choice(len(dist.choices), size=self.n_candidates,
                                 p=p_below)
            score = np.log(p_below[ks]) - np.log(np.maximum(p_above[ks], 1e-300))
            return dist.choices[int(ks[int(np.argmax(score))])]

        if isinstance(dist, _IntDist):
            # discretized-continuous: ±step/2-extended internal domain
            q = float(dist.step)
            lo, hi = dist.low - 0.5 * q, dist.high + 0.5 * q
            to_s = from_s = lambda v: np.asarray(v, dtype=float)
        elif dist.log:
            q = None
            lo, hi = math.log(dist.low), math.log(dist.high)
            to_s, from_s = np.log, np.exp
        else:
            q = None
            lo, hi = float(dist.low), float(dist.high)
            to_s = from_s = lambda v: np.asarray(v, dtype=float)

        def estimator(vals):
            mus = to_s(np.asarray(vals, dtype=float)) if len(vals) else []
            return _ParzenEstimator(mus, lo, hi, _default_weights(len(vals)),
                                    prior_weight=self.prior_weight, q=q,
                                    consider_prior=self.consider_prior)

        below_est, above_est = estimator(below), estimator(above)
        cands = below_est.sample(self.rng, self.n_candidates)
        if q is not None:
            # snap to the int grid before scoring — candidates are scored as
            # the values the trial would actually receive
            cands = np.clip(
                np.round((cands - dist.low) / q) * q + dist.low,
                dist.low, dist.high,
            )
        score = below_est.log_pdf(cands) - above_est.log_pdf(cands)
        best = float(cands[int(np.argmax(score))])
        if isinstance(dist, _IntDist):
            return int(round(best))
        # exp(log(high)) can exceed high by 1 ULP — clamp to the domain
        return min(max(float(from_s(best)), dist.low), dist.high)


# ---------------------------------------------------------------------------
# trial / study
# ---------------------------------------------------------------------------


class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self.user_attrs: Dict[str, Any] = {}
        self.value: Optional[float] = None
        self.datetime_complete: Optional[datetime.datetime] = None

    # --- suggest API ---
    def _suggest(self, name, dist):
        history = self.study._param_history(name)
        val = self.study.sampler.sample(dist, history)
        self.params[name] = val
        return val

    def suggest_int(self, name, low, high, step: int = 1):
        return self._suggest(name, _IntDist(low, high, step))

    def suggest_loguniform(self, name, low, high):
        return self._suggest(name, _FloatDist(low, high, log=True))

    def suggest_float(self, name, low, high, log: bool = False):
        return self._suggest(name, _FloatDist(low, high, log=log))

    suggest_uniform = suggest_float

    def suggest_categorical(self, name, choices):
        return self._suggest(name, _CatDist(tuple(choices)))

    def set_user_attr(self, key, value):
        self.user_attrs[key] = value


class Study:
    def __init__(self, study_name: str, storage: Optional[str] = None,
                 direction: str = "minimize", sampler: Optional[TPESampler] = None):
        assert direction in ("minimize", "maximize")
        self.study_name = study_name
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.trials: List[Trial] = []
        self._lock = threading.Lock()
        self._db_path = None
        if storage:
            assert storage.startswith("sqlite:///"), "only sqlite:/// storage supported"
            self._db_path = storage[len("sqlite:///"):]
            self._init_db()
            self._load()

    # --- storage ---
    def _conn(self):
        return sqlite3.connect(self._db_path, timeout=30)

    def _init_db(self):
        with self._conn() as c:
            c.execute(
                """CREATE TABLE IF NOT EXISTS trials (
                    study TEXT, number INTEGER, value REAL,
                    params TEXT, user_attrs TEXT, completed TEXT,
                    PRIMARY KEY (study, number))"""
            )

    def _load(self):
        with self._conn() as c:
            rows = c.execute(
                "SELECT number, value, params, user_attrs, completed FROM trials "
                "WHERE study=? ORDER BY number", (self.study_name,)
            ).fetchall()
        for number, value, params, attrs, completed in rows:
            t = Trial(self, number)
            t.value = value
            t.params = json.loads(params)
            t.user_attrs = json.loads(attrs)
            if completed:
                t.datetime_complete = datetime.datetime.fromisoformat(completed)
            self.trials.append(t)
        if rows:
            print(f"[hpo] resumed study {self.study_name!r} with {len(rows)} trials")

    def _persist(self, t: Trial):
        if not self._db_path:
            return
        with self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO trials VALUES (?,?,?,?,?,?)",
                (
                    self.study_name, t.number, t.value,
                    json.dumps(t.params), json.dumps(t.user_attrs, default=str),
                    t.datetime_complete.isoformat() if t.datetime_complete else None,
                ),
            )

    # --- sampling helpers ---
    def _param_history(self, name):
        sign = 1.0 if self.direction == "minimize" else -1.0
        # snapshot under the study lock: concurrent trial threads append to
        # self.trials and flip t.value mid-iteration under n_jobs>1
        with self._lock:
            trials = list(self.trials)
        return [
            (t.params[name], sign * t.value)
            for t in trials
            if name in t.params and t.value is not None
        ]

    # --- optimize ---
    def optimize(self, objective: Callable[[Trial], float], n_trials: int,
                 n_jobs: int = 1, callbacks: Optional[List[Callable]] = None):
        callbacks = callbacks or []

        def run_one():
            with self._lock:
                number = len(self.trials)
                trial = Trial(self, number)
                self.trials.append(trial)
            value = objective(trial)
            trial.value = float(value)
            trial.datetime_complete = datetime.datetime.now()
            with self._lock:
                self._persist(trial)
            for cb in callbacks:
                cb(self, trial)

        if n_jobs <= 1:
            for _ in range(n_trials):
                run_one()
        else:
            # thread-parallel trials (one device per trial, reference pattern)
            sem = threading.Semaphore(n_jobs)
            threads = []

            def worker():
                with sem:
                    run_one()

            for _ in range(n_trials):
                th = threading.Thread(target=worker)
                th.start()
                threads.append(th)
            for th in threads:
                th.join()

    # --- results ---
    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.value is not None]
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    @property
    def best_params(self):
        return self.best_trial.params


def create_study(study_name: str = "study", storage: Optional[str] = None,
                 load_if_exists: bool = True, direction: str = "minimize",
                 sampler: Optional[TPESampler] = None) -> Study:
    if storage and not load_if_exists and storage.startswith("sqlite:///"):
        path = storage[len("sqlite:///"):]
        if os.path.exists(path):
            os.remove(path)
    return Study(study_name, storage, direction, sampler)
