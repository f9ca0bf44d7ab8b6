"""The long-read subsamplers' keys and gates (``ops/lr_keys.py``,
``ops/strobemer.py``, ``assembly/longreads.py``) vs the JAX package.

``strobemer_hashes_plain`` against ``strobemer.strobemer_hashes`` as full
64-bit values; the per-read k-mer and strobemer keys against the JAX
package's ``_device_hash_buckets`` with ``_base_key_fn`` and the strobemer
subsampler's hasher: 32-bit keys (the JAX package runs without 64-bit
mode, so its uint64 keys are the low words) at read lengths around powers
of two (its bucket lengths), with N and the 255 that ``orient_long_read``
makes of an N.  The ragged path that the card takes is run here through
emulations of its two kernels (``kmer_hashes``, ``randstrobe_hashes``),
written from the kernels' own rules.  Then the host gate, the four
subsamplers and the minimal set: equal index lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import longreads as jlr, stage1 as js1
from rnabloom_tpu.ops import strobemer as jstrobe
from rnabloom_tpu.utils import seq as jseq
from rnabloom_tpu_torch.assembly import longreads as tlr, stage1 as ts1
from rnabloom_tpu_torch.ops import lr_keys, nthash, strobemer as tstrobe
from rnabloom_tpu_torch.utils import lrsim
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

# around the JAX package's bucket lengths (powers of two, at least 64)
EDGE_LENGTHS = [63, 64, 65, 87, 88, 127, 128, 129, 255, 256, 257, 511, 512, 513]


def _reads(seed=3):
    """lrsim reads at 7% error, reads cut to EDGE_LENGTHS, short reads,
    and reads holding N (4) or 255 (an N flipped by orient_long_read)."""
    rng = np.random.default_rng(seed)
    tx = lrsim.simulate_transcriptome(rng, 4, (400, 900))
    reads = [jseq.encode(r) for r in lrsim.simulate_reads(rng, tx, coverage=3, err=0.07)]
    base = reads[0]
    while len(base) < 600:
        base = np.concatenate([base, reads[1]])
    reads += [base[:n].copy() for n in EDGE_LENGTHS] + [base[:10].copy(), base[:24].copy(), base[:25].copy()]
    for i, code in ((2, 4), (3, 255), (4, 4)):
        r = reads[i].copy()
        pos = rng.choice(len(r), 5, replace=False)
        r[pos] = code
        reads[i] = r
    n_run = reads[5].copy()
    n_run[100:160] = 4  # a run of N wider than a strobe window
    reads.append(n_run)
    return reads


READS = _reads()


def _u64(x) -> np.ndarray:
    return (np.asarray(x.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(x.lo).astype(np.uint64)


@pytest.mark.parametrize("k,n,w_min,w_max,stranded", [
    (25, 3, 11, 50, False), (15, 2, 5, 9, False), (25, 3, 11, 50, True), (11, 4, 3, 8, False),
])
def test_strobemer_hashes_plain_equals_jax(k, n, w_min, w_max, stranded):
    L = 256
    codes = np.full((len(READS), L), 4, np.uint8)
    for i, r in enumerate(READS):
        codes[i, : min(len(r), L)] = r[:L]
    jh, jok = jstrobe.strobemer_hashes(jnp.asarray(codes), k, n, w_min, w_max, stranded=stranded)
    th, tok = tstrobe.strobemer_hashes_plain(torch.from_numpy(codes), k, n, w_min, w_max, stranded)
    ok = np.asarray(jok)
    assert np.array_equal(tok.numpy(), ok)
    assert ok.sum() > 1000 and (~ok).sum() > 100
    assert np.array_equal(th.numpy().view(np.uint64)[ok], _u64(jh)[ok])


def _jax_strobemer_fn(k, n, w_min, w_max, stranded):
    """The hasher of the JAX package's ``subsample_strobemer_based``."""

    @jax.jit
    def fn(codes):
        base, ok = jstrobe.strobemer_hashes(codes, k, n, w_min, w_max, stranded=stranded)
        return (base.hi.astype(jnp.uint64) << 32) | base.lo.astype(jnp.uint64), ok

    return fn


def _jax_kmer_keys(k, stranded):
    cfg = js1.default_graph_config(k, stranded, 1 << 20)
    return jlr._device_hash_buckets(READS, jlr._base_key_fn(cfg), k)


def _assert_same_keys(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint64 and np.array_equal(g, w.astype(np.uint64))
        assert g.max(initial=0) <= 0xFFFFFFFF


@pytest.mark.parametrize("k,stranded", [(25, False), (17, True), (35, False)])
def test_kmer_keys_equal_jax_32_bit(k, stranded):
    want = _jax_kmer_keys(k, stranded)
    # quirk 1: the JAX package's keys are uint32, the low word of the hash
    assert all(w.dtype == np.uint32 for w in want if w.size)
    got = lr_keys.kmer_keys(READS, k, stranded, device="cpu")
    _assert_same_keys(got, want)
    assert sum(g.size for g in got) > 5000
    if k == 25:  # the reads of 10, 24 and 25 bases
        assert [g.size for g in got[-4:-1]] == [0, 0, 1]
    # the low word of the full canonical hash
    r = torch.from_numpy(READS[0][None])
    fh, rh, valid = nthash.rolling_hash(r, k, stranded)
    full = nthash.canonical(fh, rh)[valid].numpy().view(np.uint64)
    assert np.array_equal(got[0], full & np.uint64(0xFFFFFFFF))
    assert (full >> np.uint64(32)).any()


@pytest.mark.parametrize("k,n,w_min,w_max,stranded", [(25, 3, 11, 50, False), (15, 3, 5, 20, True)])
def test_strobemer_keys_equal_jax(k, n, w_min, w_max, stranded):
    min_len = k + w_max * (n - 2) + w_min + 1
    want = jlr._device_hash_buckets(READS, _jax_strobemer_fn(k, n, w_min, w_max, stranded), min_len)
    got = lr_keys.strobemer_keys(READS, k, n, w_min, w_max, stranded, device="cpu")
    _assert_same_keys(got, want)
    assert sum(g.size for g in got) > 2000
    # quirk 2: the JAX package takes the anchor range from the bucket length,
    # but no anchor at or past the read's own range is valid, so the count
    # of keys of an N-free read is its own M
    for r, g in zip(READS, got):
        if len(r) >= min_len and (r < 4).all():
            assert g.size == tstrobe.num_anchors(len(r), k, n, w_min, w_max)


def _emulated_kmer_hashes(codes, offsets, k, stranded):
    """lr_kmer_keys as the kernel computes it: per base position, the
    k-mer starting there if it lies in its read (hash 0 and invalid
    otherwise)."""
    h = torch.zeros(codes.numel(), dtype=torch.int64)
    valid = torch.zeros(codes.numel(), dtype=torch.uint8)
    offs = offsets.tolist()
    for a, b in zip(offs, offs[1:]):
        if b - a >= k:
            fh, rh, ok = nthash.rolling_hash(codes[a:b], k, stranded)
            P = b - a - k + 1
            h[a : a + P] = torch.where(ok, nthash.canonical(fh, rh), 0)
            valid[a : a + P] = ok.to(torch.uint8)
    return h, valid


def _emulated_randstrobe(hash_, valid, offsets, aoff, k, n, w_min, w_max):
    """lr_randstrobe_keys as the kernel computes it, one anchor at a time."""
    hs = hash_.numpy().view(np.uint64)
    vs = valid.numpy()
    out = np.zeros(int(aoff[-1]), np.uint64)
    ok_out = np.zeros(int(aoff[-1]), np.uint8)
    mask = (1 << 64) - 1
    for i in range(len(offsets) - 1):
        base = int(offsets[i])
        P = int(offsets[i + 1]) - base - k + 1
        for a in range(int(aoff[i + 1] - aoff[i])):
            ok = a < P and vs[base + a]
            cur = int(hs[base + a]) if ok else 0
            for s in range(n - 1):
                if not ok:
                    break
                best = None
                for off in range(s * w_max + w_min, s * w_max + w_max):
                    p = a + off
                    if p >= P:
                        break
                    if not vs[base + p]:
                        continue
                    c = int(hs[base + p])
                    h = (cur ^ ((c + 0x9E3779B9 + (cur << 6) + (c >> 2)) & mask)) & mask
                    if best is None or h <= best:
                        best = h
                ok, cur = best is not None, best or 0
            out[int(aoff[i]) + a] = cur if ok else 0
            ok_out[int(aoff[i]) + a] = ok
    return torch.from_numpy(out.view(np.int64)), torch.from_numpy(ok_out)


def test_ragged_path_with_emulated_kernels_equals_plain(monkeypatch):
    """The card's layout (reads packed ragged, anchors laid out by each
    read's own length, keys selected and split on the device) gives the
    plain versions' keys when the kernels compute what they are written to."""
    monkeypatch.setattr(lr_keys, "kmer_hashes", _emulated_kmer_hashes)
    monkeypatch.setattr(tstrobe, "randstrobe_hashes", _emulated_randstrobe)
    reads = READS[:6] + READS[-len(EDGE_LENGTHS) - 4:]
    _assert_same_keys(lr_keys.kmer_keys_ragged(reads, 25, False, device="cpu"),
                      lr_keys.kmer_keys_plain(reads, 25, False, device="cpu"))
    _assert_same_keys(lr_keys.strobemer_keys_ragged(reads, 15, 3, 5, 20, False, device="cpu"),
                      lr_keys.strobemer_keys_plain(reads, 15, 3, 5, 20, False, device="cpu"))
    assert lr_keys.kmer_keys_ragged([], 25, False, device="cpu") == []


def test_kernel_wrappers_refuse_cpu_tensors():
    codes, offsets, _ = lr_keys.pack(READS[:2], "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        lr_keys.kmer_hashes(codes, offsets, 25, False)
    h = torch.zeros(codes.numel(), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA device"):
        tstrobe.randstrobe_hashes(h, h.to(torch.uint8), offsets, offsets, 25, 3, 11, 50)


def _cfgs(k=25, stranded=False):
    return js1.default_graph_config(k, stranded, 1 << 20), ts1.default_graph_config(k, stranded, 1 << 20)


@pytest.mark.parametrize("mult,log2", [(1, 24), (3, 12), (5, 24)])
def test_host_gate_equals_jax(mult, log2):
    keys = lr_keys.kmer_keys(READS, 25, False, device="cpu")
    assert tlr._host_gate(keys, 25, mult, log2) == jlr._host_gate(_jax_kmer_keys(25, False), 25, mult, log2)
    assert np.array_equal(tlr._np_multi_hash(keys[0], 25, 3), jlr._np_multi_hash(keys[0], 25, 3))


def _dup_reads():
    """Reads with heavy duplication, so that the gates drop some."""
    return READS[:12] * 4 + READS[12:]


@pytest.mark.parametrize("which", ["kmer", "strobemer", "minimizer", "minimal_set"])
def test_subsamplers_equal_jax(which):
    reads = _dup_reads()
    jcfg, tcfg = _cfgs()
    if which == "kmer":
        want = jlr.subsample_kmer_based(jcfg, reads, 2)
        got = tlr.subsample_kmer_based(tcfg, reads, 2, device="cpu")
    elif which == "strobemer":
        want = jlr.subsample_strobemer_based(jcfg, reads, max_multiplicity=2, w_min=11, w_max=50)
        got = tlr.subsample_strobemer_based(tcfg, reads, max_multiplicity=2, w_min=11, w_max=50, device="cpu")
    elif which == "minimizer":
        want = jlr.subsample_minimizer_based(jcfg, reads, max_multiplicity=2)
        got = tlr.subsample_minimizer_based(tcfg, reads, max_multiplicity=2, device="cpu")
    else:
        want = jlr.minimal_set(jcfg, reads)
        got = tlr.minimal_set(tcfg, reads, device="cpu")
    assert got == want
    assert 0 < len(got) < len(reads)
