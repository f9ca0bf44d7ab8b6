"""Port's ntHash (rnabloom_tpu_torch/ops/nthash.py) vs the JAX package's.

Exact u64 equality: the JAX package's (lo, hi) uint32 limb pairs as
lo | hi << 32 against the port's int64 bit patterns viewed as uint64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.ops import nthash as jnh
from rnabloom_tpu.ops import nthash_ref
from rnabloom_tpu_torch.ops import nthash as tnh
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


def _u64_jax(x) -> np.ndarray:
    return np.asarray(x.lo).astype(np.uint64) | (np.asarray(x.hi).astype(np.uint64) << np.uint64(32))


def _u64_torch(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def _codes(seed, shape, n_rate=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    codes[rng.random(shape) < n_rate] = 4  # N bases
    return codes


def test_constants_match_reference():
    assert tnh.SEEDS == nthash_ref.SEEDS
    assert tnh.MULTI_SEED == nthash_ref.MULTI_SEED
    assert tnh.MULTI_SHIFT == nthash_ref.MULTI_SHIFT
    assert tnh.M64 == nthash_ref.M64


# L = k gives one window (n = 1); L = k + 99 gives n > 64, so rotations wrap
@pytest.mark.parametrize("k", [17, 25, 31])
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("extra", [0, 99])
def test_rolling_hash_canonical_multi(k, stranded, extra):
    codes = _codes(k * 10 + extra, (9, k + extra))
    fh, rh, valid = jnh.rolling_hash(jnp.asarray(codes), k, stranded)
    tfh, trh, tvalid = tnh.rolling_hash(torch.from_numpy(codes), k, stranded)
    np.testing.assert_array_equal(_u64_jax(fh), _u64_torch(tfh))
    np.testing.assert_array_equal(np.asarray(valid), tvalid.numpy())
    assert (rh is None) == (trh is None) == stranded
    if not stranded:
        np.testing.assert_array_equal(_u64_jax(rh), _u64_torch(trh))
    base, tbase = jnh.canonical(fh, rh), tnh.canonical(tfh, trh)
    np.testing.assert_array_equal(_u64_jax(base), _u64_torch(tbase))
    np.testing.assert_array_equal(
        _u64_jax(jnh.multi_hash(base, k, 4)), _u64_torch(tnh.multi_hash(tbase, k, 4))
    )


@pytest.mark.parametrize("k", [17, 25, 31])
def test_rolling_hash_matches_scalar_model(k):
    codes = _codes(k, (2, k + 70))
    tfh, trh, _ = tnh.rolling_hash(torch.from_numpy(codes), k, False)
    for r in range(2):
        seq = codes[r].tolist()
        assert _u64_torch(tfh[r]).tolist() == nthash_ref.rolling_forward(seq, k)
        assert _u64_torch(trh[r]).tolist() == nthash_ref.rolling_reverse(seq, k)


@pytest.mark.parametrize("d", [1, 40])
def test_combine_and_combine_canonical(d):
    k = 25
    codes = _codes(7 + d, (6, 130))
    fh, rh, _ = jnh.rolling_hash(jnp.asarray(codes), k, False)
    tfh, trh, _ = tnh.rolling_hash(torch.from_numpy(codes), k, False)
    n = fh.lo.shape[-1] - d

    def sl(x, a):
        return jnh.U64(x.lo[..., a : a + n], x.hi[..., a : a + n])

    np.testing.assert_array_equal(
        _u64_jax(jnh.combine(sl(fh, 0), sl(fh, d))),
        _u64_torch(tnh.combine(tfh[..., :n], tfh[..., d:])),
    )
    np.testing.assert_array_equal(
        _u64_jax(jnh.combine_canonical(sl(fh, 0), sl(rh, 0), sl(fh, d), sl(rh, d))),
        _u64_torch(tnh.combine_canonical(tfh[..., :n], trh[..., :n], tfh[..., d:], trh[..., d:])),
    )


@pytest.mark.parametrize("k", [17, 25, 31])
def test_successor_hashes_match_jax(k):
    codes = _codes(k + 3, (5, k + 40))
    fh, rh, _ = jnh.rolling_hash(jnp.asarray(codes), k, False)
    tfh, trh, _ = tnh.rolling_hash(torch.from_numpy(codes), k, False)
    out = codes[:, : tfh.shape[1]]  # first base of each k-mer, N included
    f4, r4 = jnh.successor_hashes(fh, jnp.asarray(out), k, rh=rh)
    tf4, tr4 = tnh.successor_hashes(tfh, torch.from_numpy(out), k, rh=trh)
    np.testing.assert_array_equal(_u64_jax(f4), _u64_torch(tf4))
    np.testing.assert_array_equal(_u64_jax(r4), _u64_torch(tr4))
    np.testing.assert_array_equal(tnh.comp_codes(torch.from_numpy(out)).numpy(), np.asarray(jnh.comp_codes(jnp.asarray(out))))
    # the candidate of the next window's last base is that window's hash
    # (N bases have seed 0, so the slide holds across them)
    nxt_f, nxt_r = _u64_torch(tfh[:, 1:]), _u64_torch(trh[:, 1:])
    cand_f, cand_r = _u64_torch(tf4[:, :-1]), _u64_torch(tr4[:, :-1])
    idx = codes[:, k : k + nxt_f.shape[1]]
    rows, cols = np.nonzero(idx < 4)
    np.testing.assert_array_equal(cand_f[rows, cols, idx[rows, cols]], nxt_f[rows, cols])
    np.testing.assert_array_equal(cand_r[rows, cols, idx[rows, cols]], nxt_r[rows, cols])


@pytest.mark.parametrize("k", [17, 25, 31])
@pytest.mark.parametrize("side", ["right", "left"])
def test_variant_hashes_match_jax(k, side):
    """The 4 SNV variants of each k-mer's last (right) or first (left)
    base, N bases included; the variant with the k-mer's own base is the
    k-mer's hash."""
    codes = _codes(k * 7 + len(side), (5, k + 40))
    fh, rh, _ = jnh.rolling_hash(jnp.asarray(codes), k, False)
    tfh, trh, tvalid = tnh.rolling_hash(torch.from_numpy(codes), k, False)
    P = tfh.shape[1]
    cur = codes[:, k - 1 : k - 1 + P] if side == "right" else codes[:, :P]
    jfn, tfn = (jnh.variant_hashes_right, tnh.variant_hashes_right) if side == "right" else (
        jnh.variant_hashes_left, tnh.variant_hashes_left)
    f4, r4 = jfn(fh, jnp.asarray(cur), k, rh)
    tf4, tr4 = tfn(tfh, torch.from_numpy(cur), k, trh)
    np.testing.assert_array_equal(_u64_jax(f4), _u64_torch(tf4))
    np.testing.assert_array_equal(_u64_jax(r4), _u64_torch(tr4))
    rows, cols = np.nonzero(tvalid.numpy())
    own = cur[rows, cols]
    np.testing.assert_array_equal(_u64_torch(tf4)[rows, cols, own], _u64_torch(tfh)[rows, cols])
    np.testing.assert_array_equal(_u64_torch(tr4)[rows, cols, own], _u64_torch(trh)[rows, cols])
    assert tnh.variant_hashes_right(tfh, torch.from_numpy(cur), k)[1] is None
