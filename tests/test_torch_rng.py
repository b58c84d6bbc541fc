"""Squares RNG of the port against the JAX package: the integer chain
bit for bit, the counter advance, and the normals within a few ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mptrac_tpu.ops import rng as jrng
from mptrac_tpu_torch.ops import rng as trng

#: counters that exercise the low word's carry, the sign bit of the
#: int64 pattern and the wrap at 2^64
CTRS = [0, 1, 12345678901, (1 << 32) - 3, (1 << 63) - 2, (1 << 64) - 5]


@pytest.mark.parametrize("ctr", CTRS)
def test_squares_bits_bit_exact(ctr):
    n = 1000
    hi_j, lo_j = jrng.squares_bits(jnp.uint64(ctr), n)
    hi_t, lo_t = trng.squares_bits(ctr, n, device="cpu")
    np.testing.assert_array_equal(np.asarray(hi_j).astype(np.int64),
                                  hi_t.numpy())
    np.testing.assert_array_equal(np.asarray(lo_j).astype(np.int64),
                                  lo_t.numpy())


def test_squares_bits_match_limb_chain():
    """The JAX package's 32-bit limb chain (its TPU path) gives the
    same bits as the port's int64 chain."""
    ctr, n = (1 << 40) + 17, 513
    hi_j, lo_j = jrng._squares_bits_u32(jnp.uint64(ctr), n)
    hi_t, lo_t = trng.squares_bits(ctr, n, device="cpu")
    np.testing.assert_array_equal(np.asarray(hi_j).astype(np.int64),
                                  hi_t.numpy())
    np.testing.assert_array_equal(np.asarray(lo_j).astype(np.int64),
                                  lo_t.numpy())


@pytest.mark.parametrize("ctr", [0, (1 << 64) - 5])
def test_uniform_bit_exact_and_counter(ctr):
    n = 999
    u_j, c_j = jrng.squares_uniform(jnp.uint64(ctr), n)
    u_t, c_t = trng.squares_uniform(ctr, n, device="cpu")
    np.testing.assert_array_equal(np.asarray(u_j), u_t.numpy())
    assert c_t == int(c_j) == (ctr + n + 1) % (1 << 64)


@pytest.mark.parametrize("n", [9, 10, 1001])
def test_normal_f64(n):
    """float64 Box-Muller: same bits in, log/sqrt in f64 and cos/sin in
    f32 from two math libraries: 4 f32 ulp of the O(1) factor."""
    x_j, c_j = jrng.squares_normal(jnp.uint64(7), n)
    x_t, c_t = trng.squares_normal(7, n, device="cpu")
    assert c_t == int(c_j) == 7 + n + 1
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=5e-7)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_module_rng3(dtype, monkeypatch):
    """[3, n] normals of the step, counter advance 3n + 1.  f32: log,
    sqrt and cos in f32 from two libraries, a few ulp of values up to
    ~5: atol 4e-6.  A second chunk size checks that chunking the chain
    does not change the stream."""
    n = 3001
    ctr = (1 << 33) + 5
    jd = jnp.float32 if dtype == "float32" else jnp.float64
    td = torch.float32 if dtype == "float32" else torch.float64
    x_j, c_j = jrng.module_rng3(1, jnp.uint64(ctr), n, dtype=jd)
    x_t, c_t = trng.module_rng3(1, ctr, n, dtype=td, device="cpu")
    assert tuple(x_t.shape) == (3, n) and x_t.dtype == td
    assert c_t == int(c_j) == ctr + 3 * n + 1
    atol = 4e-6 if dtype == "float32" else 5e-7
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=atol)
    monkeypatch.setattr(trng, "RNG_CHUNK", 1000)
    x_c, c_c = trng.module_rng3(1, ctr, n, dtype=td, device="cpu")
    assert c_c == c_t
    np.testing.assert_array_equal(x_c.numpy(), x_t.numpy())


def test_rng_type_2_raises():
    with pytest.raises(NotImplementedError, match="RNG_TYPE 2"):
        trng.module_rng3(2, 0, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="RNG_TYPE 2"):
        trng.module_rng(2, 0, 8, 0, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ctr", [0, (1 << 33) + 5, (1 << 64) - 5])
@pytest.mark.parametrize("n", [1, 10, 2001])
def test_module_rng_uniform_bit_exact(dtype, ctr, n, monkeypatch):
    """``module_rng`` method 0 (the convection's draws): values and
    counter bit for bit in both compute modes; the float32 chain in
    passes of any size gives the same stream."""
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    x_j, c_j = jrng.module_rng(1, jnp.uint64(ctr), n, 0, dtype=jd)
    x_t, c_t = trng.module_rng(1, ctr, n, 0, dtype=td, device="cpu")
    assert x_t.dtype == td and tuple(x_t.shape) == (n,)
    assert c_t == int(c_j) == (ctr + n + 1) % (1 << 64)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    monkeypatch.setattr(trng, "RNG_CHUNK", 7)
    x_c, c_c = trng.module_rng(0, ctr, n, 0, dtype=td, device="cpu")
    assert c_c == c_t
    np.testing.assert_array_equal(x_c.numpy(), x_t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [9, 10, 2001])
def test_module_rng_normal(dtype, n):
    """``module_rng`` method 1: the uniforms under it are bit for bit
    the JAX package's, the counter too; log, sqrt, cos and sin then come
    from two math libraries (a few float32 ulp of values up to ~5):
    atol 4e-6 in float32, 5e-7 in float64 (test_normal_f64).  Measured:
    3.6e-7 and 2.0e-7."""
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ctr = 12345
    x_j, c_j = jrng.module_rng(1, jnp.uint64(ctr), n, 1, dtype=jd)
    x_t, c_t = trng.module_rng(1, ctr, n, 1, dtype=td, device="cpu")
    assert x_t.dtype == td and tuple(x_t.shape) == (n,)
    assert c_t == int(c_j) == ctr + n + 1
    atol = 4e-6 if dtype == "float32" else 5e-7
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=atol)
