"""The RNG of the port against the JAX package.  Squares (RNG_TYPE 0
and 1): the integer chain bit for bit, the counter advance, and the
normals within a few ulp.  Threefry (RNG_TYPE 2, ``jax.random``): the
key, the bits and the uniforms bit for bit, the counter advance, and the
normals, ``sqrt(2) erfinv(u)`` with PyTorch's erfinv where XLA has its
own polynomial, at rtol 1e-5 (float32) and 1e-12 (float64): measured
5.2e-6 and 8.2e-15 here, and 5.8e-6 and 9.6e-13 over 2M draws."""

import jax
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


THREEFRY_CTRS = [0, (1 << 32) + 5, (1 << 64) - 5]


@pytest.mark.parametrize("ctr", THREEFRY_CTRS)
def test_threefry_key_is_jax_fold_in(ctr):
    """``fold_in(PRNGKey(0), uint32(ctr))``: only the counter's low word
    enters the key."""
    from jax._src import prng
    k = jax.random.fold_in(jax.random.PRNGKey(0),
                           jnp.uint64(ctr).astype(jnp.uint32))
    assert tuple(int(x) for x in np.asarray(k)) == trng.threefry_key(ctr)
    bits = np.asarray(prng.threefry_2x32(np.asarray(k, np.uint32),
                                         jnp.arange(20, dtype=jnp.uint32)))
    key = trng.threefry_key(ctr)
    x = torch.arange(20, dtype=torch.int64)
    a, b = trng.threefry2x32(key[0], key[1], x[:10], x[10:])
    np.testing.assert_array_equal(np.concatenate([a, b]),
                                  bits.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ctr", THREEFRY_CTRS)
@pytest.mark.parametrize("n", [1, 10, 2001])
def test_threefry_bits_and_uniform_bit_exact(dtype, ctr, n, monkeypatch):
    """The random bits of a [3, n] draw (32-bit for float32, 64-bit for
    float64) and ``module_rng`` method 0's uniforms with the counter,
    bit for bit; and in passes of any size the same stream."""
    from jax._src import prng
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    width = 32 if dtype == "float32" else 64
    k = jax.random.fold_in(jax.random.PRNGKey(0),
                           jnp.uint64(ctr).astype(jnp.uint32))
    bj = np.asarray(prng.threefry_random_bits(k, width, (3 * n,)))
    bt = trng.threefry_bits(trng.threefry_key(ctr), 0, 3 * n, width,
                            "cpu").numpy()
    np.testing.assert_array_equal(bt, bj.astype(np.int64) if width == 32
                                  else bj.view(np.int64))
    x_j, c_j = jrng.module_rng(2, jnp.uint64(ctr), n, 0, dtype=jd)
    x_t, c_t = trng.module_rng(2, ctr, n, 0, dtype=td, device="cpu")
    assert x_t.dtype == td and tuple(x_t.shape) == (n,)
    assert c_t == int(c_j) == (ctr + n + 1) % (1 << 64)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    monkeypatch.setattr(trng, "RNG_CHUNK", 7)
    x_c, c_c = trng.module_rng(2, ctr, n, 0, dtype=td, device="cpu")
    assert c_c == c_t
    np.testing.assert_array_equal(x_c.numpy(), x_t.numpy())


#: threefry normals: the uniforms are the same bits; erfinv differs
THREEFRY_NORMAL_RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ctr", THREEFRY_CTRS)
@pytest.mark.parametrize("n", [1, 10, 2001])
def test_threefry_normals(dtype, ctr, n):
    """``module_rng3`` ([3, n], counter + 3n + 1) and ``module_rng``
    method 1 (counter + n + 1) with RNG_TYPE 2."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rtol = THREEFRY_NORMAL_RTOL[dtype]
    x_j, c_j = jrng.module_rng3(2, jnp.uint64(ctr), n, dtype=jd)
    x_t, c_t = trng.module_rng3(2, ctr, n, dtype=td, device="cpu")
    assert tuple(x_t.shape) == (3, n) and x_t.dtype == td
    assert c_t == int(c_j) == (ctr + 3 * n + 1) % (1 << 64)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=rtol,
                               atol=0)
    x_j, c_j = jrng.module_rng(2, jnp.uint64(ctr), n, 1, dtype=jd)
    x_t, c_t = trng.module_rng(2, ctr, n, 1, dtype=td, device="cpu")
    assert c_t == int(c_j) == (ctr + n + 1) % (1 << 64)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=rtol,
                               atol=0)


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


#: the float32 Squares draws of the CPU as the int64 chain gave them
#: before the card had its own kernel: per counter, the uniforms'
#: float32 bit patterns (7 from start 2), the pair normals (5 from
#: start 3) and the normal3 columns 1..3 of a draw for 5 parcels, each
#: with its advanced counter
F32_DRAWS = {
    0: (["3f6ee77e", "3f79a1dc", "3f3570b3", "3f7278e3", "3eed0208",
         "3f2107c4", "3eaa78de"], 7,
        [-0.057870130985975266, 0.7844433188438416, -0.27046439051628113,
         -0.8551560640335083, -0.8995387554168701], 6,
        [[-0.30278095602989197, 0.35691407322883606, 0.22439734637737274],
         [-0.41512054204940796, -0.9404327869415283, -0.003837419208139181],
         [0.8096364736557007, -0.7343905568122864, 0.6035516858100891]], 16),
    (1 << 63) - 5: (
        ["3db3c5e8", "3ee7c674", "3f616110", "3e891344", "3f7ae98d",
         "3f44466d", "3f76f70b"], (1 << 63) + 2,
        [0.6461498141288757, -0.056099556386470795, 0.5016368627548218,
         0.020985612645745277, -0.19926735758781433], (1 << 63) + 1,
        [[0.6829137802124023, -0.9309220314025879, -1.104055643081665],
         [0.17252770066261292, 0.24971911311149597, -0.18829025328159332],
         [-1.1514732837677002, -0.8845455646514893, 0.5163291096687317]],
        (1 << 63) + 11),
    (1 << 64) - 3: (
        ["3f23c3ef", "3f000c82", "3ebe9e6c", "3f6ee77e", "3f79a1dc",
         "3f3570b3", "3f7278e3"], 4,
        [-0.001133661367930472, 1.2837969064712524, -0.572680652141571,
         -0.05752253532409668, -0.21695221960544586], 3,
        [[1.1053812503814697, 0.22567206621170044, 0.358453631401062],
         [0.22439734637737274, -0.6570439338684082, 0.28367337584495544],
         [-0.003837419208139181, -1.2443307638168335, -0.2581064701080322]],
        13),
}


@pytest.mark.parametrize("ctr", sorted(F32_DRAWS))
def test_f32_draws_on_the_cpu_stay_plain(ctr, monkeypatch):
    """On the CPU the float32 Squares draws run the plain chain: the
    kernel library is never loaded, the uniforms and counters are the
    ones recorded bit for bit, and the normals within 4e-6 (log, sqrt,
    cos and sin of one CPU math library, as test_module_rng3)."""
    from mptrac_tpu_torch.ops import _cuda

    def no_load():
        raise AssertionError("the CPU draw loaded the CUDA kernels")

    monkeypatch.setattr(_cuda, "load", no_load)
    u_bits, cu, pairs, cp, n3, c3 = F32_DRAWS[ctr]
    u, c = trng.squares_uniform_f32(ctr, 6, "cpu", start=2)
    assert [f"{v & 0xFFFFFFFF:08x}" for v in
            u.view(torch.int32).tolist()] == u_bits
    assert c == cu
    x, c = trng.squares_normal_f32(ctr, 5, "cpu", start=3)
    np.testing.assert_allclose(x.numpy(), pairs, rtol=0, atol=4e-6)
    assert c == cp
    x, c = trng.squares_normal3_f32(ctr, 3, "cpu", part=(1, 5))
    np.testing.assert_allclose(x.numpy(), n3, rtol=0, atol=4e-6)
    assert c == c3
    for method in (0, 1):
        x, c = trng.module_rng(1, ctr, 6, method, dtype=torch.float32,
                               device="cpu", part=(2, 9))
        assert x.device.type == "cpu" and c == (ctr + 10) % (1 << 64)
    x, c = trng.module_rng3(1, ctr, 3, dtype=torch.float32, device="cpu",
                            part=(1, 5))
    np.testing.assert_allclose(x.numpy(), n3, rtol=0, atol=4e-6)
    assert c == c3
