"""Bayesian optimization of the combined priority score (paper §IV-C).

Counterpart of ``repro/core/bayesopt.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

BO = a*AOA + b*DOA + c*WDOA + d*SWDOA over standardized scores, with
(a, b, c, d) in [-1, 1]^4 tuned against the *simulated communication
overhead* of the resulting schedule.  Gaussian-process prior (RBF kernel),
expected-improvement acquisition maximized over random proposals; converges
in the paper's reported 30-40 evaluations.

Pure numpy — no dependency beyond the standard stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np


def _rbf(a: np.ndarray, b: np.ndarray, ls: float, var: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return var * np.exp(-0.5 * d2 / ls**2)


@dataclass
class GaussianProcess:
    lengthscale: float = 0.6
    variance: float = 1.0
    noise: float = 1e-4

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        self._x = x
        self._ymean = float(y.mean())
        self._ystd = float(y.std()) or 1.0
        yn = (y - self._ymean) / self._ystd
        k = _rbf(x, x, self.lengthscale, self.variance)
        k[np.diag_indices_from(k)] += self.noise
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn)
        )
        return self

    def predict(self, xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        ks = _rbf(xq, self._x, self.lengthscale, self.variance)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.maximum(self.variance - (v**2).sum(0), 1e-12)
        return mu * self._ystd + self._ymean, np.sqrt(var) * self._ystd


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)


def expected_improvement(
    gp: GaussianProcess, xq: np.ndarray, best: float, xi: float = 1e-3
) -> np.ndarray:
    mu, sigma = gp.predict(xq)
    imp = best - mu - xi  # minimization
    z = imp / np.maximum(sigma, 1e-12)
    return imp * _norm_cdf(z) + sigma * _norm_pdf(z)


@dataclass
class BOResult:
    best_x: np.ndarray
    best_y: float
    history_x: np.ndarray
    history_y: np.ndarray


def minimize(
    objective: Callable[[Sequence[float]], float],
    dim: int = 4,
    bounds: tuple[float, float] = (-1.0, 1.0),
    n_init: int = 8,
    n_iter: int = 32,
    n_proposals: int = 512,
    seed: int = 0,
) -> BOResult:
    """GP-EI minimization of a black-box objective over a box."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds
    xs = rng.uniform(lo, hi, size=(n_init, dim))
    ys = np.array([objective(x) for x in xs])
    for _ in range(n_iter):
        gp = GaussianProcess().fit(xs, ys)
        props = rng.uniform(lo, hi, size=(n_proposals, dim))
        # Local refinement around the incumbent helps late convergence.
        incumbent = xs[int(np.argmin(ys))]
        local = np.clip(
            incumbent + rng.normal(0, 0.1, size=(n_proposals // 4, dim)), lo, hi
        )
        props = np.concatenate([props, local])
        ei = expected_improvement(gp, props, float(ys.min()))
        x_next = props[int(np.argmax(ei))]
        xs = np.vstack([xs, x_next])
        ys = np.append(ys, objective(x_next))
    i = int(np.argmin(ys))
    return BOResult(xs[i], float(ys[i]), xs, ys)


def tune_swap_weights(planner, limit: int, n_iter: int = 32, seed: int = 0) -> BOResult:
    """Tune (a,b,c,d) for an AutoSwapPlanner at a given memory-load limit."""

    def objective(w) -> float:
        return planner.evaluate(limit, method=None, weights=list(w)).overhead

    return minimize(objective, dim=4, n_iter=n_iter, seed=seed)
