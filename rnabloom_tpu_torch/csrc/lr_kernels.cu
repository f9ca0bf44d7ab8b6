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
// lr_kmer_keys.  Bound: bytes (a code read, a hash and a flag written a
// position: 10 B; the rolled hash needs about 12 integer instructions a
// position, a quarter of the byte time).  A block takes a tile of
// kKmerTile consecutive positions: one warp finds the first read start
// past the tile with a 32-way search of the offsets (3 rounds for 10^4
// reads) while the other warps stage the tile's codes and their k-1 halo
// into shared memory with 16-byte loads; then the read starts inside the
// staged range are marked there (bit 3 of the staged byte), so no thread
// searches.  Each thread rolls the forward and reverse ntHash over a run of
// kKmerRun consecutive positions from the staged codes: every base is read
// from device memory once.  A code > 3 has seed 0, so the roll stays exact
// over it, and a k-mer is valid when no code > 3 and no read start past its
// first base lies in it, kept as the least position that may start a valid
// k-mer.  The seeds' four per-launch tables (in, out, each strand) sit in
// shared memory, so a warp's lookups of different codes hit different
// banks.  Hashes and flags are staged in shared memory and written with
// 16-byte stores.
//
// lr_randstrobe_keys.  Bound: integer operations.  Each anchor takes the
// minimum over (n-1)(w_max-w_min) candidates of a 64-bit add, xor, unsigned
// compare and select: 8 32-bit integer instructions a candidate, of which
// the xor, compare and select (6) run only on the integer ALU pipe (64
// lanes an SM; the add may run as IMADs on the FMA pipe), against 9 bytes
// read a position and written an anchor.  combine(a, b) =
// a ^ (b + 0x9E3779B9 + (a << 6) + (b >> 2)) is a ^ (T_b + C_a) mod 2^64
// with T_b = b + (b >> 2), staged once a position, and C_a = (a << 6) +
// 0x9E3779B9, once a strobe.  A block takes a tile of kStrobeTile
// positions (anchors are positions of their read, written at aoff[i] + a):
// one warp finds the read that holds the tile's first position while the
// others stage the tile's T_b, an invalid mask (0 or ~0) and a validity
// bitmask, with the (n-1) w_max halo of its windows, in shared memory;
// the reads that start in the tile mark their first position, and a block
// prefix max gives every position its read, so no thread searches.  A
// thread takes kStrobePer anchors of the tile (neighbouring lanes,
// neighbouring anchors: conflict-free 8-byte loads, coalesced stores).  A
// candidate is then one 8-byte and one 4-byte shared load and 8
// instructions: the 64-bit add, xor-or-mask (two 3-input LOP3s), compare
// and select, an invalid candidate giving ~0.  Two chains take a window's
// first and last halves and merge their minima; whether any candidate is
// valid comes from the bitmask, 32 at a time.  Candidates past
// kStrobeStageMax staged positions (windows of thousands of bases) are read
// from device memory.  The grid is a block a tile, so the hardware hands
// tiles to SMs as blocks end (blocks that keep a fixed share of tiles
// end far apart).
//
// consensus_vote.  Bound: bytes (a unitig code read, a polished code and
// an int32 depth written a cell, each read base read once, 8 bytes a read:
// 6 B a cell plus the batch's reads).  The vote table of the JAX function
// (16 B a cell, zeroed, scattered into and read back: about three times the
// bytes the function needs, and past the 50 MB L2 at phase 10's specified
// size) never reaches device memory.  One launch: a block takes unitig u
// and one or more tiles of kVoteTile columns (more blocks a unitig, each
// fewer tiles, when U alone would not fill the card).  It finds u's reads
// itself: the threads scan tgt in windows of kVoteList entries (8 KB for a
// 2,048-read batch, served from L2), and warp ballots append the matches'
// (read, start) to a list in shared memory (kept for the block's next tile
// when one window holds the whole batch).  A warp owns kVoteSpan
// consecutive columns, a lane every 32nd of them, and keeps their four
// base counts in registers; for each listed read that overlaps its columns
// the warp reads the read's bases there, neighbouring lanes neighbouring
// bytes, so every base is read once and no vote is an atomic.  Then each
// lane resolves its columns (depth, the first base of most votes, the
// depth floor) and writes them, coalesced, for every cell, touched or not.
// What holds it (chip_smoke.py times it with no read and with the reads
// spread evenly): at phase 10's specified size the unitig loads and the
// writes, each warp's stores waiting on its loads, take most of its time;
// at the cut cell a warp's reads, one load round after another, take about
// half.  Staging the writes in shared memory for aligned 16-byte stores did
// not help.  Both scheduling steps were timed against this kernel without
// them on one H100 80GB HBM3 at 700 W (tools/long_smoke.py --kernels-only,
// each as an --lr-variant): one block a unitig took 0.0229 ms against
// 0.0187 on 489 unitigs x 3,938 (the split gives each block one tile), and
// a list refilled every tile 0.0522 ms against 0.0479 on 3,423 x 3,938
// (there every block takes two tiles and keeps its list).
//
// The first versions of lr_kmer_keys and lr_randstrobe_keys (commit
// 514a70d: one thread a position or anchor, each with a binary search of
// the offsets) had the same C entry points, so their source builds beside
// this one and is timed against it (chip_smoke.py --lr-variant).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVoteThreads = 256;
constexpr int kVotePer = 8;                                 // columns a lane
constexpr int kVoteSpan = 32 * kVotePer;                    // consecutive columns a warp
constexpr int kVoteTile = kVoteThreads / 32 * kVoteSpan;    // columns a block takes at a time: 2,048
constexpr int kVoteScan = 8;                                // tgt entries a thread loads at once
constexpr int kVoteList = 2 * kVoteThreads * kVoteScan;     // tgt entries a window: 4,096 (a 32 KB list)
constexpr int kVoteBlocks = 132 * 8;                        // blocks a launch aims at: 2 waves of 4 an SM

constexpr int kMaxK = 64;
constexpr int kKmerThreads = 128;
constexpr int kKmerRun = 31;  // odd: a half-warp's 8-byte stores at stride kKmerRun hit 16 bank pairs
constexpr int kKmerTile = kKmerThreads * kKmerRun;  // 3968 positions, a multiple of 16
constexpr int kKmerStage = kKmerTile + kMaxK;       // staged codes: the tile and up to 63 of halo
constexpr int kStageBreak = 8;                      // staged-code bit: a read starts here

constexpr int kStrobeThreads = 256;
constexpr int kStrobeTile = 1024;  // positions a block takes at a time
constexpr int kStrobePer = kStrobeTile / kStrobeThreads;
constexpr int kStrobeStageMax = 3072;  // staged positions at most (T_b and mask: 36 KB)

// Published ntHash 64-bit seeds of A, C, G, T (rnabloom_tpu_torch/ops/nthash.py).
__constant__ uint64_t kSeeds[4] = {0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL, 0x20323ED082572324ULL,
                                   0x295549F54BE24456ULL};

__device__ __forceinline__ uint64_t rotl(uint64_t v, int s) {
  s &= 63;
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

// The first i in [0, n] with a[i] > x (n + 1 if none), a sorted: one warp,
// each round its 32 lanes probe 32 evenly spaced entries (3 rounds for
// 10^4 entries).  Every lane of the warp calls it and gets the answer.
__device__ long long warp_upper_bound(const long long* __restrict__ a, long long n, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = -1, hi = n + 1;  // a[lo] <= x (or lo = -1), a[hi] > x (or hi = n + 1)
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step;  // lane 31 probes at or past hi
    const bool gt = p >= hi || a[p] > x;
    const int f = __ffs(__ballot_sync(0xffffffffu, gt)) - 1;
    hi = min(lo + (f + 1) * step, hi);
    lo += f * step;
  }
  return hi;
}

// One block a tile of kKmerTile positions x0..: the k-mer starting at each,
// when it lies inside its read.  hash is 0 and valid 0 where it does not or
// where it holds a code > 3.
__global__ void __launch_bounds__(kKmerThreads)
kmer_keys_kernel(const uint8_t* __restrict__ codes, const long long* __restrict__ offsets, long long n_reads,
                 long long total, int k, int stranded, long long* __restrict__ hash, uint8_t* __restrict__ valid) {
  __shared__ __align__(16) uint8_t staged[kKmerStage];  // min(code, 4) | kStageBreak where a read starts
  __shared__ __align__(16) uint64_t hs[kKmerTile];
  __shared__ __align__(16) uint8_t vs[kKmerTile];
  __shared__ uint64_t tab[4][5];  // per code: forward in, forward out, reverse out, reverse in
  __shared__ long long first_start;
  const int tid = threadIdx.x;
  const long long x0 = (long long)blockIdx.x * kKmerTile;
  const long long span_end = x0 + kKmerTile + k - 1;  // past the last base the tile's k-mers reach

  if (tid < 32) {
    // the first read start past x0 (offsets[0] is no read boundary)
    const long long i0 = warp_upper_bound(offsets, n_reads, x0);
    if (tid == 0) first_start = i0 > 0 ? i0 : 1;
  } else {
    if (tid < 52) {
      const int t = tid - 32, c = t % 5;
      const uint64_t s = c < 4 ? kSeeds[c] : 0, comp = c < 4 ? kSeeds[3 - c] : 0;
      const int which = t / 5;
      tab[which][c] = which == 0 ? s : which == 1 ? rotl(s, k) : which == 2 ? rotl(comp, 63) : rotl(comp, k - 1);
    }
    // codes past the last read's end are not bases
    const long long stop = min(total, offsets[n_reads]);
    const bool aligned = ((uintptr_t)codes & 15) == 0;
    for (int c = tid - 32; c < kKmerStage / 16; c += kKmerThreads - 32) {
      const long long x = x0 + 16LL * c;
      uint4 v;
      if (aligned && x + 16 <= stop) {
        v = *reinterpret_cast<const uint4*>(codes + x);
        v.x = __vminu4(v.x, 0x04040404u);
        v.y = __vminu4(v.y, 0x04040404u);
        v.z = __vminu4(v.z, 0x04040404u);
        v.w = __vminu4(v.w, 0x04040404u);
      } else {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const unsigned b = x + j < stop ? min((unsigned)codes[x + j], 4u) : 4u;
          w[j >> 2] |= b << (8 * (j & 3));
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(staged + 16 * c) = v;
    }
  }
  __syncthreads();
  for (long long i = first_start + tid; i <= n_reads; i += kKmerThreads) {
    const long long o = offsets[i];
    if (o >= span_end) break;
    staged[o - x0] |= kStageBreak;  // o > x0: a k-mer that starts before o may not reach it
  }
  __syncthreads();

  // Roll over the run r..r+kKmerRun-1: first the k-1 bases before its first
  // k-mer's last, over seed-0 bases, then a base in and a base out a position.
  const int r = tid * kKmerRun;
  uint64_t fh = 0, rh = 0;
  int lim = 0;  // the k-mer at r + j is valid when r + j >= lim
  for (int t = 0; t < k - 1; ++t) {
    const int v = staged[r + t], c = v & 7;
    fh = rotl(fh, 1) ^ tab[0][c];
    if (!stranded) rh = rotl(rh, 63) ^ tab[3][c];
    lim = max(lim, c == 4 ? r + t + 1 : (v & kStageBreak) ? r + t : 0);
  }
  for (int j = 0; j < kKmerRun; ++j) {
    const int q = r + j + k - 1;
    const int v = staged[q], c = v & 7;
    const int o = j > 0 ? staged[r + j - 1] & 7 : 4;
    fh = rotl(fh, 1) ^ tab[1][o] ^ tab[0][c];
    if (!stranded) rh = rotl(rh, 63) ^ tab[2][o] ^ tab[3][c];
    lim = max(lim, c == 4 ? q + 1 : (v & kStageBreak) ? q : 0);
    const bool ok = r + j >= lim;
    // canonical: the signed min, as the reference
    const uint64_t h = stranded || (long long)fh < (long long)rh ? fh : rh;
    hs[r + j] = ok ? h : 0;
    vs[r + j] = ok;
  }
  __syncthreads();

  for (int c = tid; c < kKmerTile / 2; c += kKmerThreads) {
    const long long x = x0 + 2LL * c;
    if (x + 2 <= total) {
      *reinterpret_cast<longlong2*>(hash + x) = make_longlong2((long long)hs[2 * c], (long long)hs[2 * c + 1]);
    } else if (x < total) {
      hash[x] = (long long)hs[2 * c];
    }
  }
  for (int c = tid; c < kKmerTile / 16; c += kKmerThreads) {
    const long long x = x0 + 16LL * c;
    if (x + 16 <= total) {
      *reinterpret_cast<uint4*>(valid + x) = *reinterpret_cast<const uint4*>(vs + 16 * c);
    } else {
      for (int j = 0; x + j < total; ++j) valid[x + j] = vs[16 * c + j];
    }
  }
}

// In place over rd[0..kStrobeTile): the running max (every entry >= -1).
__device__ __forceinline__ void prefix_max(int* rd) {
  __shared__ int warp_top[kStrobeThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[kStrobePer];
  int run = -1;
#pragma unroll
  for (int j = 0; j < kStrobePer; ++j) {
    run = max(run, rd[tid * kStrobePer + j]);
    v[j] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  if (lane == 31) warp_top[warp] = incl;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, warp_top[w]);
#pragma unroll
  for (int j = 0; j < kStrobePer; ++j) rd[tid * kStrobePer + j] = max(before, v[j]);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return b < a ? b : a; }

// The least (T_b + c_a) ^ cur over the staged candidates q0..q0+len-1, an
// invalid one (inv ~0) giving ~0: that never beats a valid value and ties
// only with ~0 itself.  Only the value is kept, never the offset, so the
// reference's "a tie goes to the later offset" decides no output: two
// chains take the window's first and last h = ceil(len / 2) candidates
// (the middle one twice when len is odd) and their minima merge by value.
__device__ __forceinline__ uint64_t window_min(const uint64_t* T, const uint32_t* inv, int q0, int len, uint64_t c_a,
                                               uint64_t cur) {
  const int h = (len + 1) >> 1;
  const uint64_t* t0 = T + q0;
  const uint64_t* t1 = T + q0 + len - h;
  const uint32_t* m0 = inv + q0;
  const uint32_t* m1 = inv + q0 + len - h;
  uint64_t b0 = ~0ULL, b1 = ~0ULL;
#pragma unroll 8
  for (int i = 0; i < h; ++i) {
    const uint64_t v0 = m0[i], v1 = m1[i];
    b0 = umin64(b0, ((t0[i] + c_a) ^ cur) | (v0 << 32 | v0));
    b1 = umin64(b1, ((t1[i] + c_a) ^ cur) | (v1 << 32 | v1));
  }
  return umin64(b0, b1);
}

// Whether any of the staged candidates q0..q0+len-1 is valid (the bitmask).
__device__ __forceinline__ bool window_any(const uint32_t* vm, int q0, int len) {
  bool any = false;
  for (int c = 0; c < len; c += 32) {
    const int q = q0 + c;
    uint32_t bits = __funnelshift_r(vm[q >> 5], vm[(q >> 5) + 1], q & 31);
    if (len - c < 32) bits &= (1u << (len - c)) - 1;
    any |= bits != 0;
  }
  return any;
}

// window_min and window_any from device memory, for candidates at
// positions x..x+len-1 past the staged ones (windows of thousands of bases).
__device__ uint64_t window_min_device(const long long* __restrict__ hash, const uint8_t* __restrict__ valid,
                                      long long x, long long len, uint64_t c_a, uint64_t cur, bool& any) {
  uint64_t best = ~0ULL;
  any = false;
  for (long long c = 0; c < len; ++c) {
    if (!valid[x + c]) continue;
    const uint64_t b = (uint64_t)hash[x + c];
    best = umin64(best, ((b + (b >> 2)) + c_a) ^ cur);
    any = true;
  }
  return best;
}

// A block takes the tile of kStrobeTile positions x0.. (and every
// gridDim.x-th after it).  Anchor a of read i is the k-mer at position
// offsets[i] + a, for a < aoff[i+1] - aoff[i] (the caller's M, at most len
// - k + 1), written at aoff[i] + a.  A candidate is valid when it lies
// below the read's last k-mer start + 1 and its k-mer is valid; an invalid
// candidate never wins, and an anchor whose window has no valid candidate
// is invalid (best_ok in the reference).  Shared memory (dynamic), over S
// staged positions: T_b (8 B), the invalid mask (4 B), the read of each
// tile position, the validity bitmask.
__global__ void __launch_bounds__(kStrobeThreads, 4)
randstrobe_kernel(const long long* __restrict__ hash, const uint8_t* __restrict__ valid,
                  const long long* __restrict__ offsets, const long long* __restrict__ aoff, long long n_reads, int k,
                  int n, int w_min, int w_max, int S, long long* __restrict__ out, uint8_t* __restrict__ out_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* T = reinterpret_cast<uint64_t*>(smem);
  uint32_t* inv = reinterpret_cast<uint32_t*>(T + S);  // 0 where the k-mer is valid, ~0 where not
  int* rd = reinterpret_cast<int*>(inv + S);
  uint32_t* vm = reinterpret_cast<uint32_t*>(rd + kStrobeTile);
  __shared__ long long first_read;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long total = offsets[n_reads];
  for (long long x0 = (long long)blockIdx.x * kStrobeTile; x0 < total; x0 += (long long)gridDim.x * kStrobeTile) {
    if (warp == 0) {
      const long long r = warp_upper_bound(offsets, n_reads, x0) - 1;  // the read holding x0
      if (lane == 0) first_read = r;
    }
    for (int p = tid; p < kStrobeTile; p += kStrobeThreads) rd[p] = -1;
    for (int w = warp; w < S / 32; w += kStrobeThreads / 32) {
      const long long x = x0 + 32 * w + lane;
      bool ok = false;
      uint64_t b = 0;
      if (x < total) {
        ok = valid[x] != 0;
        b = (uint64_t)hash[x];
      }
      T[32 * w + lane] = b + (b >> 2);
      inv[32 * w + lane] = ok ? 0u : ~0u;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) vm[w] = m;
    }
    if (tid < 2) vm[S / 32 + tid] = 0;
    __syncthreads();
    const long long r0 = first_read;
    if (tid == 0) rd[0] = (int)r0;
    for (long long i = r0 + 1 + tid; i < n_reads; i += kStrobeThreads) {
      const long long o = offsets[i];
      if (o >= x0 + kStrobeTile) break;
      atomicMax(&rd[o - x0], (int)i);  // of the reads that start at o, the last is not empty
    }
    __syncthreads();
    prefix_max(rd);  // rd[p]: the read holding x0 + p
    __syncthreads();

    for (int j = 0; j < kStrobePer; ++j) {
      const int p = tid + j * kStrobeThreads;
      const long long x = x0 + p;
      if (x >= total) break;
      const int i = rd[p];
      const long long base = offsets[i], first = aoff[i];
      const long long a = x - base;
      if (a >= aoff[i + 1] - first) continue;  // no anchor here
      const long long lim = offsets[i + 1] - k + 1 - x0;  // staged index of the read's last k-mer start + 1
      bool ok = (vm[p >> 5] >> (p & 31)) & 1;
      uint64_t cur = ok ? (uint64_t)hash[x] : 0;
      for (int s = 0; ok && s < n - 1; ++s) {
        const long long q0 = p + (long long)s * w_max + w_min;
        const long long len = min(q0 + (w_max - w_min), lim) - q0;  // candidates before the read's last k-mer
        const uint64_t c_a = (cur << 6) + 0x9E3779B9ULL;
        if (len <= 0) {
          ok = false;
        } else if (q0 + len <= S) {
          ok = window_any(vm, (int)q0, (int)len);
          cur = window_min(T, inv, (int)q0, (int)len, c_a, cur);
        } else {
          cur = window_min_device(hash, valid, x0 + q0, len, c_a, cur, ok);
        }
      }
      out[first + a] = ok ? (long long)cur : 0;
      out_ok[first + a] = ok;
    }
    __syncthreads();
  }
}

// The reads of unitig u among tgt[p, end), at most kVoteList of them: their
// (read, start) pairs into list, in no order (the votes add up in any
// order), and their number, which every thread of the block gets.  A
// thread loads kVoteScan entries of tgt at once, then the starts of its
// hits: two rounds of loads a kVoteThreads * kVoteScan entries.
__device__ int vote_fill(const int* __restrict__ tgt, const int* __restrict__ start, long long p, long long end,
                         int u, int2* list, int* count) {
  const int lane = threadIdx.x & 31;
  __syncthreads();  // every warp is done with the previous list
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (long long b = p; b < end; b += (long long)kVoteThreads * kVoteScan) {
    bool hit[kVoteScan];
    int st[kVoteScan];
#pragma unroll
    for (int m = 0; m < kVoteScan; ++m) {
      const long long i = b + m * kVoteThreads + threadIdx.x;
      hit[m] = i < end && tgt[i] == u;
    }
#pragma unroll
    for (int m = 0; m < kVoteScan; ++m) st[m] = hit[m] ? start[b + m * kVoteThreads + threadIdx.x] : 0;
#pragma unroll
    for (int m = 0; m < kVoteScan; ++m) {
      const unsigned mask = __ballot_sync(0xffffffffu, hit[m]);
      if (mask == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(count, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(mask & ((1u << lane) - 1));
      if (hit[m]) list[at] = make_int2((int)(b + m * kVoteThreads + threadIdx.x), st[m]);
    }
  }
  __syncthreads();
  return *count;
}

// Block (u, s) takes unitig u's tiles s, s + gridDim.y, ...: the votes of
// every read on u over the tile's columns, then per column the depth, the
// first base of most votes and the polished code (that base where the depth
// reaches min_depth on a base, else the unitig's own code).  A lane's
// columns are seg + lane + 32 k, k < kVotePer, seg its warp's first.
__global__ void __launch_bounds__(kVoteThreads, 4)
    vote_kernel(const uint8_t* __restrict__ unitigs, long long L, const uint8_t* __restrict__ reads, long long R,
                long long Lr, const int* __restrict__ tgt, const int* __restrict__ start, int min_depth,
                long long tiles, uint8_t* __restrict__ polished, int* __restrict__ depth) {
  __shared__ int2 list[kVoteList];
  __shared__ int count;
  const int u = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warp_col = (threadIdx.x >> 5) * kVoteSpan;
  const uint8_t* own = unitigs + (long long)u * L;
  int n = 0;
  bool whole = false;  // the list holds every read on u: the block's later tiles keep it
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long seg = tile * kVoteTile + warp_col;
    const int width = (int)max(0LL, min((long long)kVoteSpan, L - seg));  // the warp's columns below L
    int va[kVotePer], vc[kVotePer], vg[kVotePer], vt[kVotePer];
#pragma unroll
    for (int k = 0; k < kVotePer; ++k) va[k] = vc[k] = vg[k] = vt[k] = 0;
    long long p = 0;
    do {
      if (!whole) {
        const long long end = min(R, p + kVoteList);
        n = vote_fill(tgt, start, p, end, u, list, &count);
        whole = p == 0 && end == R;
      }
      for (int j = 0; j < n; ++j) {
        const int2 e = list[j];
        // the read covers columns e.y .. e.y + Lr - 1: offsets lo .. hi - 1 of the warp's
        const long long lo = max(0LL, (long long)e.y - seg);
        const long long hi = min((long long)width, (long long)e.y + Lr - seg);
        if (lo >= hi) continue;
        const long long base = (long long)e.x * Lr + seg - e.y;  // reads[base + o]: the base at column seg + o
        const int first = (int)lo, last = (int)hi;
#pragma unroll
        for (int k = 0; k < kVotePer; ++k) {
          const int o = lane + 32 * k;
          if (o >= first && o < last) {
            const int b = reads[base + o];
            va[k] += b == 0;
            vc[k] += b == 1;
            vg[k] += b == 2;
            vt[k] += b == 3;
          }
        }
      }
      p += kVoteList;
    } while (p < R);
#pragma unroll
    for (int k = 0; k < kVotePer; ++k) {
      const int o = lane + 32 * k;
      if (o < width) {
        const int d = va[k] + vc[k] + vg[k] + vt[k];
        int w = 0, m = va[k];
        if (vc[k] > m) { w = 1; m = vc[k]; }
        if (vg[k] > m) { w = 2; m = vg[k]; }
        if (vt[k] > m) w = 3;
        const int c = own[seg + o];
        polished[(long long)u * L + seg + o] = (d >= min_depth && c < 4) ? (uint8_t)w : (uint8_t)c;
        depth[(long long)u * L + seg + o] = d;
      }
    }
  }
}

// Staged positions of a randstrobe tile: the tile and its (n-1) w_max halo,
// in whole bitmask words, at most kStrobeStageMax.
int strobe_staged(int n, int w_max) {
  const long long want = (kStrobeTile + (long long)(n - 1) * w_max + 31) / 32 * 32;
  return (int)(want < kStrobeStageMax ? want : kStrobeStageMax);
}

// Over S staged positions: T_b (8 B) and the invalid mask (4 B) each, the
// read of each tile position, the validity bitmask and two words past it.
size_t strobe_smem(int S) { return (size_t)S * 12 + kStrobeTile * 4 + (S / 32 + 2) * 4; }

}  // namespace

extern "C" {

// hash and valid: 16-byte aligned (written with 16-byte stores).
int lr_kmer_keys(const void* codes, const void* offsets, long long n_reads, long long total, int k, int stranded,
                 void* hash, void* valid, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)hash | (uintptr_t)valid) & 15) return (int)cudaErrorMisalignedAddress;
  if (total > 0) {
    kmer_keys_kernel<<<(unsigned int)((total + kKmerTile - 1) / kKmerTile), kKmerThreads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)codes, (const long long*)offsets, n_reads, total, k,
                                               stranded, (long long*)hash, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a block of lr_randstrobe_keys takes.
int lr_randstrobe_smem(int n, int w_max) { return (int)strobe_smem(strobe_staged(n, w_max)); }

// offsets[0] = 0, offsets[n_reads] = the positions of hash and valid,
// aoff[0] = 0, and read i has at most max(len - k + 1, 0) anchors (the
// wrapper checks).  The number of positions is on the card; a tile of
// kStrobeTile positions holds at most kStrobeTile anchors, so the grid is
// twice the least number of tiles with anchors: a block a tile where the
// reads are mostly anchors (the hardware hands tiles to SMs as blocks end,
// which keeps them busy to the end), and blocks loop over tiles where they
// are not.
int lr_randstrobe_keys(const void* hash, const void* valid, const void* offsets, const void* aoff,
                       long long n_reads, long long n_anchors, int k, int n, int w_min, int w_max, void* out,
                       void* out_ok, void* stream) {
  if (n_anchors <= 0) return (int)cudaGetLastError();
  if (n_reads >= INT_MAX || n < 2 || w_min < 1 || w_max <= w_min) return (int)cudaErrorInvalidValue;
  const int S = strobe_staged(n, w_max);
  const size_t smem = strobe_smem(S);
  const long long tiles = (n_anchors + kStrobeTile - 1) / kStrobeTile;
  const long long grid = 2 * tiles < INT_MAX ? 2 * tiles : INT_MAX;
  randstrobe_kernel<<<(unsigned int)grid, kStrobeThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)hash, (const uint8_t*)valid, (const long long*)offsets, (const long long*)aoff, n_reads, k, n,
      w_min, w_max, S, (long long*)out, (uint8_t*)out_ok);
  return (int)cudaGetLastError();
}

// votes: not read (null from the port's wrapper).  It stays in the argument
// list so that an older source, whose kernel scatters into a zeroed int32
// table of U * L * 4 entries there, builds and is timed beside this one.
int consensus_vote(const void* unitigs, long long U, long long L, const void* reads, long long R, long long Lr,
                   const void* tgt, const void* start, int min_depth, void* votes, void* polished, void* depth,
                   void* stream) {
  (void)votes;
  if (U <= 0 || L <= 0) return (int)cudaGetLastError();
  if (U > INT_MAX || R > INT_MAX || R < 0 || Lr < 0) return (int)cudaErrorInvalidValue;
  // blocks a unitig, so that a small U still fills the card, each taking
  // the same number of its tiles
  const long long tiles = (L + kVoteTile - 1) / kVoteTile;
  long long splits = (kVoteBlocks + U - 1) / U;
  if (splits > 65535) splits = 65535;
  const long long per = (tiles + splits - 1) / splits;
  splits = (tiles + per - 1) / per;
  vote_kernel<<<dim3((unsigned int)U, (unsigned int)splits), kVoteThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)unitigs, L, (const uint8_t*)reads, R, Lr, (const int*)tgt, (const int*)start, min_depth, tiles,
      (uint8_t*)polished, (int*)depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
