"""Unit tests for utils/xfer.py: its helpers must be exactly equivalent
to the plain transfers and constructors they stand for.
"""
import numpy as np
import jax.numpy as jnp

from tpu_multigrid.utils.xfer import (device_complex, device_full,
                                      device_zeros_like, host_complex)


def test_device_complex_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 8, 8)) + 1j * rng.normal(size=(3, 8, 8))
    for dt in (jnp.complex64, jnp.complex128):
        z = device_complex(a, dt)
        assert z.dtype == jnp.dtype(dt)
        np.testing.assert_allclose(host_complex(z), a.astype(np.dtype(dt)),
                                   rtol=0, atol=0)


def test_device_complex_real_input_and_none_dtype():
    a = np.arange(12.0).reshape(3, 4)
    z = device_complex(a, jnp.complex64)
    assert z.dtype == jnp.complex64
    np.testing.assert_array_equal(np.asarray(jnp.real(z)), a)
    c = (a + 2j * a).astype(np.complex128)
    z2 = device_complex(c, None)          # keep input dtype
    assert z2.dtype == jnp.dtype(np.complex128) or str(z2.dtype) == "complex64"
    np.testing.assert_allclose(host_complex(z2), c.astype(z2.dtype))


def test_device_full_matches_jnp_full():
    for val, dt in ((0.0, jnp.complex64), (1.0, jnp.complex128),
                    (2.5, jnp.float32), (1 + 2j, jnp.complex64)):
        got = device_full((2, 3, 3), val, dt)
        ref = jnp.full((2, 3, 3), val, dt)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(np.asarray(jnp.real(got)),
                                      np.asarray(jnp.real(ref)))
        np.testing.assert_array_equal(np.asarray(jnp.imag(got)),
                                      np.asarray(jnp.imag(ref)))


def test_device_zeros_like():
    z = device_complex(np.ones((4, 4)) + 1j, jnp.complex64)
    out = device_zeros_like(z)
    assert out.dtype == z.dtype and out.shape == z.shape
    assert float(jnp.abs(out).sum()) == 0.0


def test_host_complex_real_passthrough():
    x = jnp.arange(6.0, dtype=jnp.float32)
    np.testing.assert_array_equal(host_complex(x), np.arange(6.0,
                                                             dtype=np.float32))
