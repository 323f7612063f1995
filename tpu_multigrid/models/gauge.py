"""U(1) gauge fields on the 2D periodic lattice.

Layout: links are a complex array ``U[2, L, L]`` (direction-major,
lattice-last) with ``U[0]`` the +x links and ``U[1]`` the +y links; n_color=1
so each link is a unit-modulus complex number (the reference stores 1x1
ColorMatrix objects, gauge.h:30-38).

Capabilities mirrored from the reference Gauge class (gauge.h:6-123):
identity init, average plaquette, phase-file ("heat-bath") import, complex
text import/export — plus what the reference lacks: our own U(1) heat-bath
ensemble generator (the reference reads files produced by an external MCMC
code that is absent from its repo, gauge.h:44).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def identity_gauge(L: int, dtype=jnp.complex128) -> jnp.ndarray:
    """Free field: all links 1 (reference gauge.h:35)."""
    from ..utils.xfer import device_full
    return device_full((2, L, L), 1.0, dtype)


def gauge_from_phases(phases: np.ndarray, dtype=jnp.complex128) -> jnp.ndarray:
    """U = exp(i * phase), phases shaped [2, L, L]."""
    from ..utils.xfer import device_complex
    return device_complex(np.exp(1j * np.asarray(phases)), dtype)


def random_gauge(L: int, key, width: float = 0.2, dtype=jnp.complex128):
    """Gaussian-phase links about the identity (reference gauge.h:25-36's
    commented-out 'Gaussian local phase' option)."""
    import jax
    ph = width * jax.random.normal(key, (2, L, L))
    return jnp.exp(1j * ph).astype(dtype)


def plaquette(U: jnp.ndarray) -> jnp.ndarray:
    """Average plaquette Re-trace, complex mean over sites.

    P(x) = U0(x) U1(x+x^) U0(x+y^)^* U1(x)^*  (reference gauge.h:58-59).
    Lattice axes: x = axis -2, y = axis -1; site (x+1,y) = roll(-1, axis=-2).
    """
    u0, u1 = U[0], U[1]
    p = (u0 * jnp.roll(u1, -1, axis=-2)
         * jnp.conj(jnp.roll(u0, -1, axis=-1)) * jnp.conj(u1))
    return jnp.mean(p)


def gauge_transform(U: jnp.ndarray, omega: jnp.ndarray) -> jnp.ndarray:
    """U'_mu(x) = Omega(x) U_mu(x) Omega(x+mu)^dagger.

    omega: [L, L] unit-modulus complex field. (Reference
    6_ntl-mg_new_code/1_new_code/tests.h f_gauge_transform.)
    """
    u0 = omega * U[0] * jnp.conj(jnp.roll(omega, -1, axis=-2))
    u1 = omega * U[1] * jnp.conj(jnp.roll(omega, -1, axis=-1))
    return jnp.stack([u0, u1])


# ---------------------------------------------------------------------------
# Heat-bath ensemble generation (setup-time; NumPy on host).
#
# U(1) Wilson action S = -beta * sum_plaq Re P. The single-link conditional
# distribution is von Mises: p(theta) ~ exp(beta*|V| cos(theta + arg V))
# where V is the link's staple sum. We sweep checkerboard-ordered links.
# The reference's ensembles came from an external heat-bath code
# (gauge.h:44, beta=32.0 at params.h:66); this generator replaces it.
# ---------------------------------------------------------------------------

def _staples(theta: np.ndarray, mu: int) -> np.ndarray:
    """Sum of the two staples attached to link (x, mu), as complex numbers.

    With P(x) = U0(x) U1(x+x^) U0(x+y^)* U1(x)*, the plaquettes containing
    U_mu(x) contribute Re[U_mu(x) * V(x,mu)] to sum Re P, V = staple sum.
    """
    u = np.exp(1j * theta)
    u0, u1 = u[0], u[1]
    xp = lambda a: np.roll(a, -1, axis=-2)   # value at (x+1, y)
    yp = lambda a: np.roll(a, -1, axis=-1)   # value at (x, y+1)
    xm = lambda a: np.roll(a, 1, axis=-2)
    ym = lambda a: np.roll(a, 1, axis=-1)
    if mu == 0:
        # P(x):     U0(x) [U1(x+x^) U0(x+y^)* U1(x)*]
        # P(x-y^):  U0(x-y^) U1(x+x^-y^) U0(x)* U1(x-y^)*  -> conj contains U0(x)
        v1 = xp(u1) * np.conj(yp(u0)) * np.conj(u1)
        v2 = np.conj(xp(ym(u1))) * np.conj(ym(u0)) * ym(u1)
        return v1 + v2
    else:
        # P(x):     U1(x)* appears -> staple for U1(x) from conj side
        # P(x-x^):  U0(x-x^) U1(x) U0(x-x^+y^)* U1(x-x^)*
        v1 = np.conj(xp(u1)) * np.conj(u0) * yp(u0)
        v2 = xm(u0) * np.conj(yp(xm(u0))) * np.conj(xm(u1))
        return v1 + v2


def heatbath_ensemble(L: int, beta: float, n_sweeps: int = 200,
                      seed: int = 4302529, theta0: np.ndarray | None = None,
                      prefer_native: bool = True):
    """Generate U(1) link phases [2, L, L] via checkerboard heat-bath.

    Returns phases (float64). Sampling: theta ~ vonMises(kappa=beta*|V|,
    mu=-arg V) so that p ~ exp(beta*|V|*cos(theta + arg V)).

    Uses the native C++ generator (tpu_multigrid/native/heatbath.cpp) when
    the toolchain is available — the Markov chain is inherently
    sequential; the NumPy fallback below is the same checkerboard
    algorithm, vectorized per parity class.
    """
    if prefer_native:
        try:
            from ..utils import native
            if native.available():
                th = (np.zeros((2, L, L)) if theta0 is None
                      else np.array(theta0, dtype=np.float64))
                return native.heatbath_run(th, beta, n_sweeps, seed)
        except Exception:
            pass
    rng = np.random.default_rng(seed)
    theta = np.zeros((2, L, L)) if theta0 is None else np.array(theta0)
    x = np.arange(L)[:, None]
    y = np.arange(L)[None, :]
    parity = (x + y) % 2
    for _ in range(n_sweeps):
        for mu in (0, 1):
            for par in (0, 1):
                V = _staples(theta, mu)
                kappa = beta * np.abs(V)
                mean = -np.angle(V)
                prop = rng.vonmises(mean, np.maximum(kappa, 1e-12))
                mask = parity == par
                theta[mu][mask] = prop[mask]
    return theta


def wilson_action_density(theta: np.ndarray, beta: float) -> float:
    u = np.exp(1j * theta)
    p = (u[0] * np.roll(u[1], -1, axis=-2)
         * np.conj(np.roll(u[0], -1, axis=-1)) * np.conj(u[1]))
    return float(-beta * np.mean(np.real(p)))


# ---------------------------------------------------------------------------
# Reference file formats (SURVEY.md Appendix B).
# ---------------------------------------------------------------------------

def read_heatbath_file(path: str, L: int, dtype=jnp.complex128) -> jnp.ndarray:
    """Read `phase_{L}_b{beta}.dat`: one phase per line, order x->y->mu
    (reference gauge.h:103-107: outer x, then y, then mu)."""
    ph = np.loadtxt(path).reshape(L, L, 2)          # [x, y, mu]
    ph = np.transpose(ph, (2, 0, 1))                # [mu, x, y]
    return gauge_from_phases(ph, dtype)


def write_heatbath_file(path: str, theta: np.ndarray):
    ph = np.transpose(np.asarray(theta), (1, 2, 0)).reshape(-1)  # x,y,mu order
    np.savetxt(path, ph, fmt="%.18e")


def read_gauge_text(path: str, L: int, dtype=jnp.complex128) -> jnp.ndarray:
    """Read `Uphases.txt`-format complex links 're+i im' per line
    (reference gauge.h:65-86), order x->y->mu."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            re, im = line.split("+i")
            vals.append(complex(float(re), float(im)))
    u = np.array(vals).reshape(L, L, 2)
    from ..utils.xfer import device_complex
    return device_complex(np.transpose(u, (2, 0, 1)), dtype)


def write_gauge_text(path: str, U: jnp.ndarray):
    from ..utils.xfer import host_complex
    u = np.transpose(host_complex(U), (1, 2, 0)).reshape(-1)
    with open(path, "w") as f:
        for v in u:
            f.write(f"{v.real:25.20e}+i{v.imag:25.20e}\n")
