"""Adaptive near-null vector generation.

Near-null vectors are found by relaxing D x = 0 from a random start for
`null_iters` sweeps, renormalizing globally every `iters_per_norm` sweeps
(reference Level::f_near_null, level.h:177-249; 500 sweeps, renorm every 4).

Data-parallel twist: the nc (or nc/2 for Wilson) candidate vectors are
independent given their random starts — we relax them all at once with
`vmap` instead of the reference's sequential d1 loop.

Wilson chirality split (level.h:223-248): each of the nc/2 relaxed vectors
is split into its upper-spinor part (row d1) and lower-spinor part
(row nc/2 + d1), zero-padded — doubling the coarse dof and preserving
gamma5-structure on coarse levels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .smoothers import smooth
from .norms import normalize


def relax_null_vectors(D, D0inv, starts, null_iters: int,
                       iters_per_norm: int, smoother: str, omega: float = 1.0,
                       joint_qr: bool = False):
    """Relax each start vector toward the near-null space of D.

    starts: [k, nf, L, L]. Returns same shape, globally normalized.

    joint_qr=False reproduces the reference's scheme: each candidate is
    relaxed INDEPENDENTLY (level.h:177-249 d1 loop), differing only by
    its random start. On very small lattices (<= ~4^2 setup levels) the
    relaxation contracts every candidate onto the single lowest mode and
    the candidates become globally parallel — the subsequent block
    Gram-Schmidt then divides by ~0 (the reference's f_ortho would
    exit(1) on the same degeneracy, near_null.h:149-159).

    joint_qr=True orthonormalizes the candidate SET (global modified
    Gram-Schmidt) at every renormalization point — block power iteration
    toward the lowest k modes instead of k copies of mode 1. Robust at
    any level size; a beyond-reference option (MGConfig.null_joint_qr).
    """
    zero_r = jnp.zeros_like(starts[0])
    blocks = max(null_iters // iters_per_norm, 1)

    if not joint_qr:
        def one(v):
            def body(_, v):
                v = smooth(D, D0inv, v, zero_r, iters_per_norm, smoother,
                           omega)
                v, _ = normalize(v)
                return v
            return jax.lax.fori_loop(0, blocks, body, v)

        return jax.vmap(one)(starts)

    k = starts.shape[0]

    def mgs(vs):
        """Global modified Gram-Schmidt over the candidate axis."""
        out = []
        for i in range(k):
            v = vs[i]
            for u in out:
                v = v - u * jnp.vdot(u, v)
            n = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2))
            out.append(v / jnp.where(n > 0, n, 1.0))
        return jnp.stack(out)

    def body(_, vs):
        vs = jax.vmap(lambda v: smooth(D, D0inv, v, zero_r, iters_per_norm,
                                       smoother, omega))(vs)
        return mgs(vs)

    return jax.lax.fori_loop(0, blocks, body, mgs(starts))


def candidates_to_phi_null(vecs: jnp.ndarray, stencil: str, nc: int):
    """Pack relaxed candidates into phi_null[nc, nf, L, L].

    laplace: row d = conj(vec_d)  (conjugated for gauge covariance,
             level.h:218-219).
    wilson:  vec_d (d < nc/2) splits chirally into rows d and nc/2 + d.
    """
    k, nf, L, _ = vecs.shape
    if stencil == "laplace":
        assert k == nc
        return jnp.conj(vecs)
    assert k == nc // 2
    half = nf // 2
    upper = jnp.concatenate(
        [jnp.conj(vecs[:, :half]), jnp.zeros_like(vecs[:, half:])], axis=1)
    lower = jnp.concatenate(
        [jnp.zeros_like(vecs[:, :half]), jnp.conj(vecs[:, half:])], axis=1)
    return jnp.concatenate([upper, lower], axis=0)


def random_starts(key, k: int, nf: int, L: int, dtype):
    """Random real uniform(-pi, pi) starts, as the reference's
    f_init_near_null_vector(rand=1) (modules_indiv.h:51-68)."""
    import math
    re = jax.random.uniform(key, (k, nf, L, L), minval=-math.pi, maxval=math.pi)
    return re.astype(dtype)
