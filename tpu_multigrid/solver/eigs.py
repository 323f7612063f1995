"""On-device spectral estimators: power iteration and Lanczos.

The reference measures operator spectra by materializing the dense
(n L^2) x (n L^2) matrix in a notebook and calling numpy.linalg.eigvals
(analysis_nbks/spectrum_calc/1_compute_spectrum.ipynb) — O(L^6), only
feasible for tiny lattices. These matrix-free estimators run the same
measurements at any L as a handful of stencil applications on the device:

- `power_extreme`   : largest |lambda| of ANY operator (power iteration).
- `lanczos_extremes`: extremal eigenvalues of a HERMITIAN operator
  (Lanczos tridiagonalization, no reorthogonalization — accurate for the
  extremes at modest iteration counts).
- `hermitian_form`  : the Hermitian form of a stencil operator —
  D itself for laplace, gamma5 D for wilson (gamma5-hermiticity,
  reference tests.h:94-182); works on coarse Galerkin levels too since
  near-null rows are chirality-blocked (models.operators.gamma5).
- `spectral_interval`: (lambda_min, lambda_max) of the Hermitian form —
  the spectrum edges at any lattice size; also supplies the bound
  estimates behind `chebyshev_config` (the Chebyshev smoother interval).

All loops are `lax.scan`/`fori_loop` under one jitted program per call;
only the k x k tridiagonal eigenproblem runs on host.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.operators import gamma5
from ..ops.stencil import apply_D, _site_matvec
from ..utils.xfer import device_complex


def _norm(v):
    return jnp.sqrt(jnp.sum(jnp.abs(v) ** 2))


def power_extreme(matvec: Callable, v0: jnp.ndarray, iters: int = 50):
    """Largest |lambda| (spectral radius estimate) by power iteration.

    Returns (lmax, v): the Rayleigh-quotient magnitude after `iters`
    normalized applications, and the final vector. Jitted as one program.
    """
    def run(v0):
        def body(_, v):
            w = matvec(v)
            return w / _norm(w)

        v = jax.lax.fori_loop(0, iters, body, v0 / _norm(v0))
        w = matvec(v)
        lam = jnp.abs(jnp.vdot(v, w)) / jnp.sum(jnp.abs(v) ** 2)
        return lam.real, v

    return jax.jit(run)(v0)


def lanczos_tridiag(matvec: Callable, v0: jnp.ndarray, k: int = 48):
    """k-step Lanczos for a HERMITIAN operator: returns (alpha[k],
    beta[k-1]) of the tridiagonal projection T_k. Extremal eigenvalues of
    T_k converge rapidly to those of the operator (no reorthogonalization:
    interior ghost eigenvalues may appear, the extremes stay reliable)."""
    def run(v0):
        v0n = v0 / _norm(v0)

        def step(carry, _):
            v_prev, v, beta_prev = carry
            w = matvec(v) - beta_prev.astype(v.dtype) * v_prev
            alpha = jnp.real(jnp.vdot(v, w))
            w = w - alpha.astype(v.dtype) * v
            beta = _norm(w)
            safe = jnp.maximum(beta, jnp.finfo(beta.dtype).tiny)
            return (v, w / safe.astype(v.dtype), beta), (alpha, beta)

        init = (jnp.zeros_like(v0n), v0n, jnp.zeros((), v0.real.dtype))
        _, (alphas, betas) = jax.lax.scan(step, init, None, length=k)
        return alphas, betas

    alphas, betas = jax.jit(run)(v0)
    return np.asarray(alphas), np.asarray(betas)[:-1]


def lanczos_extremes(matvec: Callable, v0: jnp.ndarray,
                     k: int = 48) -> Tuple[float, float]:
    """(lambda_min, lambda_max) estimates of a Hermitian operator."""
    alphas, betas = lanczos_tridiag(matvec, v0, k)
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def hermitian_form(D: jnp.ndarray, stencil: str) -> Callable:
    """Matvec of the Hermitian form: D (laplace) or gamma5 D (wilson)."""
    n = D.shape[1]
    if stencil == "laplace":
        return lambda v: apply_D(D, v)
    g5 = device_complex(gamma5(n), D.dtype)
    return lambda v: jnp.einsum("ij,jxy->ixy", g5, apply_D(D, v))


def spectral_interval(D: jnp.ndarray, stencil: str, k: int = 48,
                      seed: int = 0) -> Tuple[float, float]:
    """Extremal eigenvalues of the operator's Hermitian form, matrix-free.

    laplace: spectrum of D itself (Hermitian; negative-definite in the
    reference's sign convention — diag is stored as -(4+m), SURVEY App. A).
    wilson: spectrum of gamma5 D (Hermitian, always indefinite). These are
    the spectrum EDGES at any lattice size; the reference's dense notebook
    eigenanalysis is O(L^6) and only feasible at tiny L. Criticality (the
    interior gap of gamma5 D closing at m_c) is probed separately, e.g. by
    eo/MR convergence or the dense spectrum at small L (PARITY.md)."""
    n, L = D.shape[1], D.shape[-1]
    rng = np.random.default_rng(seed)
    v0 = device_complex(rng.normal(size=(n, L, L))
                        + 1j * rng.normal(size=(n, L, L)), D.dtype)
    return lanczos_extremes(hermitian_form(D, stencil), v0, k)


def chebyshev_config(cfg, hier, lmin_frac: float = None, iters: int = 40):
    """Return a copy of `cfg` set up for the Chebyshev smoother: estimate
    lambda_max of D0^{-1} D on every level of `hier` by power iteration
    and fill cfg.cheby_lmax. Build the hierarchy with another smoother
    first (setup needs no intervals), then solve with the returned config:

        hier = mg.build_hierarchy(D, cfg)
        out = mg.solve(hier, b, eigs.chebyshev_config(cfg, hier))
    """
    lmaxs = tuple(jacobi_operator_lmax(lev.D, lev.D0inv, iters)
                  for lev in hier.levels)
    kw = {"smoother": "chebyshev", "cheby_lmax": lmaxs}
    if lmin_frac is not None:
        kw["cheby_lmin_frac"] = lmin_frac
    return cfg.replace(**kw)


def jacobi_operator_lmax(D: jnp.ndarray, D0inv: jnp.ndarray,
                         iters: int = 40, seed: int = 0) -> float:
    """Largest |lambda| of the Jacobi-preconditioned operator
    A = D0^{-1} D — the upper end of the Chebyshev smoother's interval."""
    n, L = D.shape[1], D.shape[-1]
    rng = np.random.default_rng(seed)
    v0 = device_complex(rng.normal(size=(n, L, L))
                        + 1j * rng.normal(size=(n, L, L)), D.dtype)
    lam, _ = power_extreme(
        lambda v: _site_matvec(D0inv, apply_D(D, v)), v0, iters)
    return float(lam)
