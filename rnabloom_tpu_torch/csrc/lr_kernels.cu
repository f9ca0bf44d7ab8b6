// Long-read device programs for Hopper (sm_90a), bound with ctypes.
//
// Three kernels of the long-read path (-long), each computing what an XLA
// program of the JAX package computes, value for value:
//
//   lr_kmer_keys        rnabloom_tpu/assembly/longreads.py:337-349
//                       (_base_key_fn, run through _device_hash_buckets
//                       :307-334): the canonical ntHash of every k-mer of
//                       every read (the forward hash when stranded) and
//                       whether the k-mer holds only A/C/G/T.
//   lr_randstrobe_keys  rnabloom_tpu/ops/strobemer.py:33-94
//                       (strobemer_hashes): per anchor k-mer, n-1 strobes,
//                       each the window candidate minimising
//                       combine(cur, cand) as unsigned 64-bit, the later
//                       offset on a tie.
//   consensus_vote      rnabloom_tpu/olc/consensus.py:88-116 (_vote_kernel):
//                       one batch of placed reads votes per (unitig,
//                       position, base) into a zeroed table; then depth,
//                       the first-max argmax and the depth floor.
//
// Reads are ragged: codes concatenated (uint8, 4 or more = not a base) with
// int64 offsets, offsets[i]..offsets[i+1] the bases of read i.  The JAX
// package pads each read into a (64, 2^j) bucket so that XLA compiles one
// program per shape; here nothing is compiled per shape, so nothing is
// padded.  Its strobemer anchor range, M = (L - k + 1) - w_max (n - 2) -
// w_min with L the bucket length, admits no valid anchor past the M of the
// read's own length (the last window of such an anchor lies past the
// read's last k-mer), so the caller lays the anchors out by the read's own
// length.
//
// What bounds them: bytes.  lr_kmer_keys reads each base k times from L1/L2
// (one thread per k-mer position, the k-mer hashed directly as the XOR of
// rotated seeds, so no thread waits on another) and writes 9 bytes a
// position; lr_randstrobe_keys reads (n-1)(w_max-w_min) hashes of a window
// per anchor, neighbouring anchors sharing them through L1, and writes 9
// bytes an anchor; consensus_vote adds one vote a read base with a
// fire-and-forget atomic (RED) into an int32 table that stays in L2 at the
// smoke's size, then reads 16 bytes and writes 5 per unitig position.
// Simple kernels, right first: none stages its inputs in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // a grid-stride loop over 132 SMs

__device__ __forceinline__ uint64_t rotl(uint64_t v, int s) {
  s &= 63;
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

// Published ntHash 64-bit seeds of A, C, G, T (rnabloom_tpu_torch/ops/nthash.py).
__device__ __forceinline__ uint64_t seed(int c) {
  switch (c) {
    case 0: return 0x3C8BFBB395C60474ULL;
    case 1: return 0x3193C18562A02B4CULL;
    case 2: return 0x20323ED082572324ULL;
    default: return 0x295549F54BE24456ULL;
  }
}

// Pair-hash combiner: a ^ (b + 0x9e3779b9 + (a << 6) + (b >> 2)).
__device__ __forceinline__ uint64_t combine(uint64_t a, uint64_t b) {
  return a ^ (b + 0x9E3779B9ULL + (a << 6) + (b >> 2));
}

// Index of the segment of a sorted offsets array (n + 1 entries, offsets[0]
// = 0) that holds g: the last i with offsets[i] <= g.
__device__ __forceinline__ long long segment_of(const long long* offsets, long long n, long long g) {
  long long lo = 0, hi = n;  // offsets[lo] <= g < offsets[hi]
  while (hi - lo > 1) {
    long long mid = (lo + hi) >> 1;
    if (offsets[mid] <= g) lo = mid; else hi = mid;
  }
  return lo;
}

long long grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// One thread per base position g: the k-mer starting there, when it lies
// inside its read.  hash is 0 and valid 0 where it does not or where it
// holds a code > 3.
__global__ void kmer_keys_kernel(const uint8_t* __restrict__ codes, const long long* __restrict__ offsets,
                                 long long n_reads, long long total, int k, int stranded,
                                 long long* __restrict__ hash, uint8_t* __restrict__ valid) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    long long end = offsets[segment_of(offsets, n_reads, g) + 1];
    uint64_t fh = 0, rh = 0;
    bool ok = g + k <= end;
    for (int j = 0; ok && j < k; ++j) {
      int c = codes[g + j];
      if (c > 3) {
        ok = false;
        break;
      }
      fh ^= rotl(seed(c), k - 1 - j);
      rh ^= rotl(seed(3 - c), j);
    }
    long long h = 0;
    if (ok) h = stranded ? (long long)fh : min((long long)fh, (long long)rh);  // signed min, as the reference
    hash[g] = h;
    valid[g] = ok;
  }
}

// One thread per anchor.  aoff[i]..aoff[i+1] are read i's anchors (M of
// them; 0 for a read too short); anchor a of read i
// is the k-mer at position a, whose hash is hash[offsets[i] + a] when a < P
// = len - k + 1.  A candidate is valid when its position lies below P and
// its k-mer is valid; an invalid candidate never wins, and an anchor whose
// window has no valid candidate is invalid (best_ok in the reference).
__global__ void randstrobe_kernel(const long long* __restrict__ hash, const uint8_t* __restrict__ valid,
                                  const long long* __restrict__ offsets, const long long* __restrict__ aoff,
                                  long long n_reads, long long n_anchors, int k, int n, int w_min, int w_max,
                                  long long* __restrict__ out, uint8_t* __restrict__ out_ok) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < n_anchors;
       g += (long long)gridDim.x * blockDim.x) {
    long long i = segment_of(aoff, n_reads, g);
    long long a = g - aoff[i];
    long long base = offsets[i];
    long long P = offsets[i + 1] - base - k + 1;
    bool ok = a < P && valid[base + a];
    uint64_t cur = ok ? (uint64_t)hash[base + a] : 0;
    for (int s = 0; ok && s < n - 1; ++s) {
      uint64_t best = 0;
      bool best_ok = false;
      for (int off = s * w_max + w_min; off < s * w_max + w_max; ++off) {
        long long p = a + off;
        if (p >= P) break;
        if (!valid[base + p]) continue;
        uint64_t h = combine(cur, (uint64_t)hash[base + p]);
        if (!best_ok || h <= best) {  // unsigned; a tie goes to the later offset
          best = h;
          best_ok = true;
        }
      }
      ok = best_ok;
      cur = best;
    }
    out[g] = ok ? (long long)cur : 0;
    out_ok[g] = ok;
  }
}

// One thread per (read, position) of the batch: a vote for the base where
// it is one and its unitig position lies in [0, L).
__global__ void vote_scatter_kernel(const uint8_t* __restrict__ reads, long long R, long long Lr,
                                    const int* __restrict__ tgt, const int* __restrict__ start, long long L,
                                    int* __restrict__ votes) {
  long long total = R * Lr;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    int c = reads[g];
    long long r = g / Lr;
    long long pos = (long long)start[r] + (g - r * Lr);
    if (c < 4 && pos >= 0 && pos < L) atomicAdd(&votes[((long long)tgt[r] * L + pos) * 4 + c], 1);
  }
}

// One thread per (unitig, position): depth, the first base of most votes,
// and the polished code where the depth reaches min_depth on a base.
__global__ void vote_resolve_kernel(const uint8_t* __restrict__ unitigs, long long cells,
                                    const int4* __restrict__ votes, int min_depth,
                                    uint8_t* __restrict__ polished, int* __restrict__ depth) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < cells;
       g += (long long)gridDim.x * blockDim.x) {
    int4 v = votes[g];
    int d = v.x + v.y + v.z + v.w;
    int w = 0, m = v.x;
    if (v.y > m) { w = 1; m = v.y; }
    if (v.z > m) { w = 2; m = v.z; }
    if (v.w > m) { w = 3; }
    uint8_t u = unitigs[g];
    polished[g] = (d >= min_depth && u < 4) ? (uint8_t)w : u;
    depth[g] = d;
  }
}

}  // namespace

extern "C" {

int lr_kmer_keys(const void* codes, const void* offsets, long long n_reads, long long total, int k, int stranded,
                 void* hash, void* valid, void* stream) {
  if (total > 0) {
    kmer_keys_kernel<<<(unsigned int)grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const long long*)offsets, n_reads, total, k, stranded, (long long*)hash,
        (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

int lr_randstrobe_keys(const void* hash, const void* valid, const void* offsets, const void* aoff,
                       long long n_reads, long long n_anchors, int k, int n, int w_min, int w_max, void* out,
                       void* out_ok, void* stream) {
  if (n_anchors > 0) {
    randstrobe_kernel<<<(unsigned int)grid_for(n_anchors), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)hash, (const uint8_t*)valid, (const long long*)offsets, (const long long*)aoff, n_reads,
        n_anchors, k, n, w_min, w_max, (long long*)out, (uint8_t*)out_ok);
  }
  return (int)cudaGetLastError();
}

// votes: a zeroed int32 table of U * L * 4 entries, 16-byte aligned.
int consensus_vote(const void* unitigs, long long U, long long L, const void* reads, long long R, long long Lr,
                   const void* tgt, const void* start, int min_depth, void* votes, void* polished, void* depth,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R * Lr > 0) {
    vote_scatter_kernel<<<(unsigned int)grid_for(R * Lr), kThreads, 0, s>>>(
        (const uint8_t*)reads, R, Lr, (const int*)tgt, (const int*)start, L, (int*)votes);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (U * L > 0) {
    vote_resolve_kernel<<<(unsigned int)grid_for(U * L), kThreads, 0, s>>>(
        (const uint8_t*)unitigs, U * L, (const int4*)votes, min_depth, (uint8_t*)polished, (int*)depth);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
