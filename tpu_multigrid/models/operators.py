"""Level-0 lattice operator assembly: gauged Laplace and Wilson-Dirac.

The operator at every level is a gauge-covariant 5-point stencil stored as a
complex array ``D[5, n, n, L, L]`` — direction index first (0=same, 1=+x,
2=-x, 3=+y, 4=-y, matching the reference's D(X, idx) convention, level.h:8),
dof indices next, lattice planes last so the per-direction (n x n) blocks are
contiguous L x L planes that vectorise along the lattice.

Math (reference level.h:131-175):
  laplace: D0 = -(4+m) I;  D_{+mu} = U_mu(x);  D_{-mu} = U_mu(x-mu)^dagger
  wilson:  D0 = (2+m) I;   D_{+mu} = U_mu(x) * 1/2 (I - gamma_mu)
           D_{-mu} = U_mu(x-mu)^dagger * 1/2 (I + gamma_mu)
  gamma1 = sigma_x, gamma2 = sigma_y, gamma5 = diag(1, -1).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def gamma_matrices(n: int = 2, dtype=np.complex128):
    """2D Euclidean gamma matrices (reference level.h:161-162)."""
    g1 = np.array([[0, 1], [1, 0]], dtype=dtype)
    g2 = np.array([[0, -1j], [1j, 0]], dtype=dtype)
    return g1, g2


def gamma5(n: int, dtype=np.complex128):
    """Chirality matrix: diag(+1 on upper half, -1 on lower half).

    For coarse Wilson levels (n=4) the same upper/lower split applies
    because near-null vectors are stored chirality-blocked
    (reference tests.h:144-149 builds gamma5 this way for any n).
    """
    d = np.ones(n, dtype=dtype)
    d[n // 2:] = -1.0
    return np.diag(d)


def assemble_laplace(U: jnp.ndarray, m: float) -> jnp.ndarray:
    """Gauged Laplace stencil, n=1: D[5, 1, 1, L, L].

    (D phi)(x) = -(4+m) phi(x) + U_x(x) phi(x+x^) + U_x(x-x^)* phi(x-x^)
               + U_y(x) phi(x+y^) + U_y(x-y^)* phi(x-y^)
    (reference level.h:146-152; diagonal stored negative).
    """
    L = U.shape[-1]
    dt = U.dtype
    from ..utils.xfer import device_full
    one = device_full((L, L), 1.0, dt)
    d0 = -(4.0 + m) * one
    dxp = U[0]
    dxm = jnp.conj(jnp.roll(U[0], 1, axis=-2))   # U_x(x - x^)^*
    dyp = U[1]
    dym = jnp.conj(jnp.roll(U[1], 1, axis=-1))   # U_y(x - y^)^*
    D = jnp.stack([d0, dxp, dxm, dyp, dym])      # [5, L, L]
    return D[:, None, None, :, :]                # [5, 1, 1, L, L]


def assemble_wilson(U: jnp.ndarray, m: float) -> jnp.ndarray:
    """Wilson-Dirac stencil, n=2: D[5, 2, 2, L, L].

    (D psi)(x) = (2+m) psi(x)
               + sum_mu [ U_mu(x) P^-_mu psi(x+mu) + U_mu(x-mu)^* P^+_mu psi(x-mu) ]
    with P^±_mu = 1/2 (I ± gamma_mu). The hopping sign convention follows the
    reference exactly (level.h:165-171): hopping terms stored with + sign and
    projector 1/2(I∓gamma); the diagonal is +(2+m) I.
    """
    L = U.shape[-1]
    dt = U.dtype
    from ..utils.xfer import device_complex, device_full
    g1, g2 = gamma_matrices(dtype=np.complex128)
    eye = np.eye(2, dtype=np.complex128)
    pm1 = device_complex(0.5 * (eye - g1), dt)   # for +x
    pp1 = device_complex(0.5 * (eye + g1), dt)   # for -x
    pm2 = device_complex(0.5 * (eye - g2), dt)   # for +y
    pp2 = device_complex(0.5 * (eye + g2), dt)   # for -y

    ux, uy = U[0], U[1]
    uxm = jnp.conj(jnp.roll(ux, 1, axis=-2))
    uym = jnp.conj(jnp.roll(uy, 1, axis=-1))

    def hop(proj, link):
        # [2,2] x [L,L] -> [2,2,L,L]
        return proj[:, :, None, None] * link[None, None, :, :]

    d0 = (2.0 + m) * device_complex(eye, dt)[:, :, None, None] \
        * device_full((L, L), 1.0, dt)[None, None]
    return jnp.stack([d0, hop(pm1, ux), hop(pp1, uxm),
                      hop(pm2, uy), hop(pp2, uym)])


def assemble(stencil: str, U: jnp.ndarray, m: float) -> jnp.ndarray:
    if stencil == "laplace":
        return assemble_laplace(U, m)
    if stencil == "wilson":
        return assemble_wilson(U, m)
    raise ValueError(f"unknown stencil {stencil!r}")


def wilson_free_spectrum(L: int, m: float) -> np.ndarray:
    """Analytic free-field Wilson eigenvalues for validation
    (reference analysis_nbks/spectrum_calc/1_compute_spectrum.ipynb):
    for each momentum (kx, ky): (2+m) + 2? Actually with our sign convention,
    eigenvalues of the stencil are
      lam(k) = (2+m) + cos kx + cos ky ± i sqrt(sin^2 kx + sin^2 ky)
    since the projector hopping sums to cos-terms on the identity and
    i*sin-terms on the gammas. Returns the 2 L^2 eigenvalues.
    """
    k = 2.0 * np.pi * np.arange(L) / L
    kx, ky = np.meshgrid(k, k, indexing="ij")
    re = (2.0 + m) + np.cos(kx) + np.cos(ky)
    im = np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
    return np.concatenate([(re + 1j * im).ravel(), (re - 1j * im).ravel()])
