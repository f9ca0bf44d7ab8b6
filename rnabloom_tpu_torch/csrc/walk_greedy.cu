// Greedy de Bruijn graph walk for Hopper (sm_90a), bound with ctypes.
//
// Replaces the XLA while-loop of rnabloom_tpu/graph/traverse.py::
// _extend_walks_fused (mode="greedy", no terminators, no back-branch
// checks, spec_hops = 1): supersteps of walk_superstep alternating with
// resolve_branches, until no lane is ACTIVE or BRANCH or max_supersteps
// ran.  The walk state that comes out equals the lockstep loop's, field for
// field (graph/traverse.py::extend_walks_plain is the plain version).
//
// One thread per walk lane.  In the lockstep loop an inactive lane leaves
// the superstep body unchanged and resolve_branches touches only BRANCH
// lanes, so each lane's trajectory depends on that lane alone:
//
//   for s < max_supersteps, while the lane is ACTIVE or BRANCH:
//       up to superstep_hops hops while ACTIVE
//       then, if BRANCH, one greedy resolve
//
// and a thread runs exactly that, with no host round trip.  One hop:
// read the out code buf[pos-k]; derive the 4 successor hashes (ntHash
// slide) and their query hashes (signed min of the strands, or the
// forward strand when stranded: rh for left walks); count-min lookup of
// each over num_hash cells; the first candidate with count >=
// max(min_cov, 1) is the move when it is the only one; cycle-ring scan;
// full check (pos >= max_len-1 or hops >= bound); status by the reference
// precedence DEAD, BRANCH, CYCLE, FULL; append.  A resolve scores each
// viable candidate by the greedy lookahead tree (the max over paths of
// the path's min count; depth 3 exhaustive, deeper levels a max-count
// descent from each depth-3 leaf) and takes the best score, then the
// higher count, then the smaller base.
//
// Counter layouts: mf8 (a 256-entry float32 decode table built by the
// wrapper from the port's own minifloat.decode), u16 (read unsigned),
// int32, and int32 blocked (all of a key's cells in one 128-cell row, as
// bloom/filters.py::blocked_cells places them).
//
// What bounds it on this card: the latency of dependent random reads.
// Each hop reads 4 x num_hash cells of a counter table far larger than L2
// (512 MiB at -mem 1) and cannot start before the previous hop picked its
// base; a resolve at lookahead 3 reads 84 x num_hash cells.  A stage-2
// batch has about 10^4 lanes, under one resident warp per SM scheduler
// at 128 threads a block, so the card mostly waits on memory.  This first
// kernel keeps every lane's state in registers and its cycle ring and
// buffer in global memory (L1-resident per lane); the Hopper redesign
// (several lanes' lookups in flight per thread, rings in shared memory)
// is later work.
//
// The entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

constexpr int kActive = 0;
constexpr int kBranch = 1;
constexpr int kDead = 2;
constexpr int kCycle = 3;
constexpr int kFull = 5;

constexpr int kMf8 = 0;
constexpr int kU16 = 1;
constexpr int kI32 = 2;
constexpr int kI32Blocked = 3;

// published ntHash 64-bit seeds of A, C, G, T (N has seed 0)
__constant__ uint64_t kSeeds[4] = {
    0x3C8BFBB395C60474ull, 0x3193C18562A02B4Cull,
    0x20323ED082572324ull, 0x295549F54BE24456ull,
};

struct Walk {
  uint8_t* buf;
  int32_t* pos;
  int64_t* fh;
  int64_t* rh;
  int64_t* hist;
  int32_t* status;
  int32_t* hops;
  float* path_min;
  const float* min_cov;
  const int32_t* bound;
  int W, max_len, cycle_window;
  const void* cbf;
  const float* decode;
  int layout, size_log2, num_hash;
  uint64_t kms;  // k * MULTI_SEED mod 2^64
  int k, stranded, left, lookahead, superstep_hops, max_supersteps;
};

__device__ __forceinline__ uint64_t rotl(uint64_t x, int s) {
  s &= 63;
  return s ? (x << s) | (x >> (64 - s)) : x;
}

__device__ __forceinline__ uint64_t seed_of(int c) { return c < 4 ? kSeeds[c] : 0ull; }

// successor hashes of a k-mer whose first base is `out`:
//   fh' = rotl(fh,1) ^ rotl(seed[out], k) ^ seed[c]
//   rh' = rotr(rh,1) ^ rotr(seed[comp out], 1) ^ rotl(seed[comp c], k-1)
__device__ __forceinline__ void successors(const Walk& p, uint64_t fh, uint64_t rh, int out,
                                           uint64_t f4[4], uint64_t r4[4]) {
  const uint64_t t = rotl(fh, 1) ^ rotl(seed_of(out), p.k);
  const uint64_t tr = rotl(rh, 63) ^ rotl(seed_of(out < 4 ? 3 - out : out), 63);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f4[c] = t ^ kSeeds[c];
    r4[c] = tr ^ rotl(kSeeds[3 - c], p.k - 1);
  }
}

__device__ __forceinline__ uint64_t query(const Walk& p, uint64_t fh, uint64_t rh) {
  if (p.stranded) return p.left ? rh : fh;
  return (int64_t)fh < (int64_t)rh ? fh : rh;
}

// NTM64 hash i of a base hash: h_0 = base, h_i = t ^ (t >>> 27),
// t = base * (i ^ k * MULTI_SEED)
__device__ __forceinline__ uint64_t multi(const Walk& p, uint64_t base, int i) {
  if (i == 0) return base;
  const uint64_t t = base * ((uint64_t)i ^ p.kms);
  return t ^ (t >> 27);
}

// count-min estimate of one k-mer, as float32
__device__ float count_of(const Walk& p, uint64_t q) {
  if (p.layout == kI32Blocked) {
    const int rows_log2 = p.size_log2 - 7;
    const uint64_t rmask = rows_log2 >= 32 ? 0xFFFFFFFFull : ((1ull << rows_log2) - 1);
    const int32_t* cells = (const int32_t*)p.cbf + ((q >> 1) & rmask) * 128;
    const uint32_t lane0 = (uint32_t)(q >> 40) & 127u;
    int32_t m = cells[lane0];
    for (int i = 1; i < p.num_hash; ++i) {
      const uint32_t step = (uint32_t)(multi(p, q, i) & 0xFFFFFFFFull) % 127u + 1u;
      const int32_t v = cells[(lane0 + step * (uint32_t)i) & 127u];
      m = v < m ? v : m;
    }
    return __int2float_rn(m);
  }
  const uint64_t mask = (1ull << p.size_log2) - 1;
  float best = INFINITY;
  for (int i = 0; i < p.num_hash; ++i) {
    const uint64_t idx = (multi(p, q, i) >> 1) & mask;
    float v;
    if (p.layout == kMf8) {
      v = p.decode[((const uint8_t*)p.cbf)[idx]];
    } else if (p.layout == kU16) {
      v = __int2float_rn((int)((const uint16_t*)p.cbf)[idx]);
    } else {
      v = __int2float_rn(((const int32_t*)p.cbf)[idx]);
    }
    best = fminf(best, v);
  }
  return best;
}

__device__ __forceinline__ void candidates(const Walk& p, uint64_t fh, uint64_t rh, int out,
                                           uint64_t f4[4], uint64_t r4[4], uint64_t q4[4],
                                           float cnt[4]) {
  successors(p, fh, rh, out, f4, r4);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q4[c] = query(p, f4[c], r4[c]);
    cnt[c] = count_of(p, q4[c]);
  }
}

// first index of the maximum of 4 values
__device__ __forceinline__ int argmax4(const float v[4]) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < 4; ++c)
    if (v[c] > v[best]) best = c;
  return best;
}

struct Lane {
  const Walk& p;
  uint8_t* buf;
  int64_t* hist;
  int32_t pos, hops, status, bound;
  uint64_t fh, rh;
  float path_min, min_count;  // min_count = max(min_cov, 1)

  __device__ int buf_at(int i) const {
    i = i < 0 ? 0 : (i > p.max_len - 1 ? p.max_len - 1 : i);
    return buf[i];
  }

  __device__ bool in_hist(uint64_t q) const {
    bool hit = false;
    for (int j = 0; j < p.cycle_window; ++j) hit |= (uint64_t)hist[j] == q;
    return hit;
  }

  __device__ void advance(int c, const uint64_t f4[4], const uint64_t r4[4],
                          const uint64_t q4[4], const float cnt[4]) {
    buf[pos < p.max_len - 1 ? pos : p.max_len - 1] = (uint8_t)c;
    hist[(hops + 1) % p.cycle_window] = (int64_t)q4[c];
    fh = f4[c];
    rh = r4[c];
    path_min = fminf(path_min, cnt[c]);
    ++pos;
    ++hops;
  }

  // walk_superstep's body for one ACTIVE lane
  __device__ void hop() {
    uint64_t f4[4], r4[4], q4[4];
    float cnt[4];
    candidates(p, fh, rh, buf_at(pos - p.k), f4, r4, q4, cnt);
    int nviable = 0, code = -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (cnt[c] >= min_count) {
        ++nviable;
        if (code < 0) code = c;
      }
    }
    if (code < 0) code = 0;
    const bool cyc = in_hist(q4[code]);
    const bool full = pos >= p.max_len - 1 || hops >= bound;
    if (nviable == 0) {
      status = kDead;
    } else if (nviable > 1) {
      status = kBranch;
    } else if (cyc) {
      status = kCycle;
    } else if (full) {
      status = kFull;
    } else {
      advance(code, f4, r4, q4, cnt);
    }
  }

  // greedy lookahead score of candidate (f, r) with count c0
  __device__ float score(uint64_t f, uint64_t r, float c0) const {
    if (p.lookahead == 1) return c0;
    uint64_t f1[4], r1[4], q1[4];
    float c1[4];
    candidates(p, f, r, buf_at(pos - p.k + 1), f1, r1, q1, c1);
    float best = -INFINITY;
    if (p.lookahead == 2) {
#pragma unroll
      for (int n = 0; n < 4; ++n) best = fmaxf(best, fminf(c0, c1[n]));
      return best;
    }
    const int out2 = buf_at(pos - p.k + 2);
    for (int n1 = 0; n1 < 4; ++n1) {
      uint64_t f2[4], r2[4], q2[4];
      float c2[4];
      candidates(p, f1[n1], r1[n1], out2, f2, r2, q2, c2);
      const float m1 = fminf(c0, c1[n1]);
      for (int n2 = 0; n2 < 4; ++n2) {
        float pm = fminf(m1, c2[n2]);
        uint64_t fl = f2[n2], rl = r2[n2];
        for (int i = 0; i < p.lookahead - 3; ++i) {
          uint64_t f3[4], r3[4], q3[4];
          float c3[4];
          candidates(p, fl, rl, buf_at(pos - p.k + 3 + i), f3, r3, q3, c3);
          const int b = argmax4(c3);
          fl = f3[b];
          rl = r3[b];
          pm = fminf(pm, c3[b]);
        }
        best = fmaxf(best, pm);
      }
    }
    return best;
  }

  // resolve_branches(mode="greedy") for one BRANCH lane
  __device__ void resolve() {
    uint64_t f4[4], r4[4], q4[4];
    float cnt[4], s[4];
    candidates(p, fh, rh, buf_at(pos - p.k), f4, r4, q4, cnt);
    float top = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = cnt[c] >= min_count ? score(f4[c], r4[c], cnt[c]) : -1.0f;
      top = fmaxf(top, s[c]);
    }
    float key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) key[c] = (s[c] >= top && cnt[c] >= min_count) ? cnt[c] : -1.0f;
    const int best = argmax4(key);
    if (in_hist(q4[best])) {
      status = kCycle;
    } else if (pos >= p.max_len - 1) {
      status = kFull;
    } else {
      status = kActive;
      advance(best, f4, r4, q4, cnt);
    }
  }
};

__global__ void walk_greedy_kernel(Walk p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.W) return;
  Lane lane{p,
            p.buf + (size_t)w * p.max_len,
            p.hist + (size_t)w * p.cycle_window,
            p.pos[w], p.hops[w], p.status[w], p.bound[w],
            (uint64_t)p.fh[w], (uint64_t)p.rh[w],
            p.path_min[w], fmaxf(p.min_cov[w], 1.0f)};
  for (int s = 0; s < p.max_supersteps; ++s) {
    if (lane.status != kActive && lane.status != kBranch) break;
    for (int h = 0; h < p.superstep_hops && lane.status == kActive; ++h) lane.hop();
    if (lane.status == kBranch) lane.resolve();
  }
  p.pos[w] = lane.pos;
  p.hops[w] = lane.hops;
  p.status[w] = lane.status;
  p.fh[w] = (int64_t)lane.fh;
  p.rh[w] = (int64_t)lane.rh;
  p.path_min[w] = lane.path_min;
}

}  // namespace

extern "C" {

int walk_greedy(uint8_t* buf, int32_t* pos, int64_t* fh, int64_t* rh, int64_t* hist,
                int32_t* status, int32_t* hops, float* path_min, const float* min_cov,
                const int32_t* bound, int W, int max_len, int cycle_window, const void* cbf,
                int layout, int size_log2, int num_hash, const float* decode,
                unsigned long long kms, int k, int stranded, int left, int lookahead,
                int superstep_hops, int max_supersteps, void* stream) {
  if (W <= 0) return 0;
  Walk p{buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound,
         W, max_len, cycle_window, cbf, decode, layout, size_log2, num_hash,
         (uint64_t)kms, k, stranded, left, lookahead, superstep_hops, max_supersteps};
  walk_greedy_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
