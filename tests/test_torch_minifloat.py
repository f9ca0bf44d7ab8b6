"""Port's MiniFloat codec (rnabloom_tpu_torch/ops/minifloat.py) vs the JAX
package's, exactly: every code 0-255 (invalid > 127 included) with the
deltas and u01 values of tests/test_histmerge.py's exhaustive check."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.ops import minifloat as jmf
from rnabloom_tpu_torch.ops import minifloat as tmf
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

CODES = np.arange(256, dtype=np.uint8)
DELTAS = np.array([0, 1, 2, 3, 5, 7, 8, 15, 16, 100, 127, 128, 1000, 4096, 100000], np.int32)
U01 = (0.0, 0.01, 0.25, 0.4999, 0.5, 0.75, 0.9999)


@pytest.mark.parametrize("u", U01)
def test_increment_and_stochastic_encode_exhaustive(u):
    C, D = np.meshgrid(CODES, DELTAS, indexing="ij")
    tc, td, tu = torch.from_numpy(C), torch.from_numpy(D), torch.full(C.shape, u)
    uu = jnp.full(C.shape, u, jnp.float32)
    want_inc = np.asarray(jmf.increment_codes(jnp.asarray(C), jnp.asarray(D), uu))
    np.testing.assert_array_equal(tmf.increment_codes(tc, td, tu).numpy(), want_inc)
    want_enc = np.asarray(
        jmf.encode_stochastic(jmf.decode(jnp.asarray(C)) + jnp.asarray(D).astype(jnp.float32), uu)
    )
    got_enc = tmf.encode_stochastic(tmf.decode(tc) + td.to(torch.float32), tu).numpy()
    np.testing.assert_array_equal(got_enc, want_enc)
    # and the fused path equals the float codec in the port too
    np.testing.assert_array_equal(got_enc, want_inc)


def test_decode_encode_encode_floor():
    np.testing.assert_array_equal(
        tmf.decode(torch.from_numpy(CODES)).numpy(), np.asarray(jmf.decode(jnp.asarray(CODES)))
    )
    rng = np.random.default_rng(0)
    counts = np.concatenate([
        np.arange(0, 300, 0.5, dtype=np.float32),
        (rng.random(5000) * 300000).astype(np.float32),
        np.array([7.5, 8, 8192, 245760, 1e9, -3], np.float32),
    ])
    for jf, tf in ((jmf.encode, tmf.encode), (jmf.encode_floor, tmf.encode_floor)):
        np.testing.assert_array_equal(tf(torch.from_numpy(counts)).numpy(), np.asarray(jf(jnp.asarray(counts))))


@pytest.mark.parametrize("salt", [0, 1, 4095, 2**31 + 5, 2**32 - 1])
def test_mix_u01(salt):
    idx = np.random.default_rng(salt % 1000).integers(0, 2**32, size=100_000, dtype=np.uint32)
    want = np.asarray(jmf.mix_u01(jnp.asarray(idx), salt))
    got = tmf.mix_u01(torch.from_numpy(idx.astype(np.int64)), salt).numpy()
    np.testing.assert_array_equal(got, want)
