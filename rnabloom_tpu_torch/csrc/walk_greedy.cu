// Greedy de Bruijn graph walk for Hopper (sm_90a), bound with ctypes.
//
// Replaces the XLA while-loop of rnabloom_tpu/graph/traverse.py::
// _extend_walks_fused (mode="greedy", no terminators, no back-branch
// checks, spec_hops = 1): supersteps of walk_superstep alternating with
// resolve_branches, until no lane is ACTIVE or BRANCH or max_supersteps
// ran.  The walk state that comes out equals the lockstep loop's, field for
// field (graph/traverse.py::extend_walks_plain is the plain version).
//
// In the lockstep loop an inactive lane leaves the superstep body unchanged
// and resolve_branches touches only BRANCH lanes, so each lane's
// trajectory depends on that lane alone:
//
//   for s < max_supersteps, while the lane is ACTIVE or BRANCH:
//       up to superstep_hops hops while ACTIVE
//       then, if BRANCH, one greedy resolve
//
// One hop: read the out code buf[pos-k]; derive the 4 successor hashes
// (ntHash slide) and their query hashes (signed min of the strands, or the
// forward strand when stranded: rh for left walks); count-min lookup of
// each over num_hash cells; the first candidate with count >= max(min_cov,
// 1) is the move when it is the only one; cycle-ring scan; full check (pos
// >= max_len-1 or hops >= bound); status by the reference precedence DEAD,
// BRANCH, CYCLE, FULL; append.  A resolve scores each viable candidate by
// the greedy lookahead tree (the max over paths of the path's min count;
// depth 3 exhaustive, deeper levels a max-count descent from each depth-3
// leaf) and takes the best score, then the higher count, then the smaller
// base.
//
// Counter layouts: mf8 (a 256-entry float32 decode table built by the
// wrapper from the port's own minifloat.decode, copied to shared memory),
// u16 (read unsigned), int32, and int32 blocked (all of a key's cells in one
// 128-cell row, as bloom/filters.py::blocked_cells places them).
//
// What bounds it on this card: the rate of random reads, and their
// latency.  A stage-2 batch (16,384 lanes on a 512 MiB table) needs about
// 80M cell reads, each a random 32 B sector: 0.78 ms of DRAM bytes at
// 3.35 TB/s, but the card serves random sectors far below that rate (one
// torch gather of as many random cells of the same table takes 2.7-2.9 ms
// on an H100, chip_smoke.py phase 4).  Each hop's reads depend on the
// previous hop's choice, and the longest lanes make about 500 hops and 64
// resolves.  So the design aims at few round trips per lane, and at enough
// lanes in flight to keep the memory system busy:
//
//  * A tile of G = 8 threads per lane (cooperative_groups::tiled_partition,
//    fixed: 16 was no faster, 32 slower).  Every thread of a tile keeps the
//    lane's state and follows its control flow, so one lane's phases never
//    diverge.  16,384 lanes make 4,096 warps at G = 8, against the 512 of
//    one thread per lane; the kernel asks for 3 blocks an SM
//    (__launch_bounds__), so 12,672 lanes are resident at G = 8.
//  * Each level's cell reads are issued before any is consumed.  A thread
//    owns k-mers j = rank + G*m of a level and issues all their num_hash
//    reads together (count_many), so a hop is one round trip and a resolve
//    `lookahead` of them: 4, then 16, then 64 k-mers, then the 64 max-count
//    descents advancing together, 256 k-mers a level.  A hop's 4 counts are
//    the resolve's first level, and the chosen candidate's 4 children,
//    read at the resolve's level 1, are the next hop's candidates: both
//    are reused.  Subtrees of candidates below the coverage floor are not
//    read: their scores are not used.
//  * Off the round trip: the next hop's out code is loaded, and the cycle
//    ring scanned for all 4 candidates, while a hop's reads are in flight.
//  * Minima and maxima across the tile go through shuffles; every argmax
//    is over 4 values each thread holds, and keeps the first maximum, as
//    jnp.argmax does.
//  * The kernel is templated on the counter layout and on num_hash (1, 2,
//    3, or 0: any other value, read one hash at a time), and on whether the
//    lookahead is past depth 3, so the read loops have no run-time switch
//    and the lookahead-3 kernel pays no registers for the descents.
//  * The cycle ring lives in shared memory.  Thread r owns ring slots
//    j = r (mod G): it loads them, scans them (a shuffle OR joins the
//    verdicts), writes the pushes that land on them and stores them back at
//    exit, so the ring needs no barrier.  The buffer stays in global memory
//    (rank 0 appends, tile.sync() publishes the byte to the tile).
//
// The entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int G = 8;  // threads per walk lane
static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two in [4, 32]");
constexpr int kThreads = 256;       // threads per block (fewer when rings need it)
constexpr int kBlocksPerSm = 3;     // resident blocks an SM asks for: <= 85 registers a thread
constexpr int kRingPad = 8;         // int64 slots between two lanes' rings
constexpr int kDecodeBytes = 1024;  // the mf8 decode table in shared memory

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
constexpr uint64_t kSeed0 = 0x3C8BFBB395C60474ull;
constexpr uint64_t kSeed1 = 0x3193C18562A02B4Cull;
constexpr uint64_t kSeed2 = 0x20323ED082572324ull;
constexpr uint64_t kSeed3 = 0x295549F54BE24456ull;

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
  int W, max_len, cycle_window, ring_stride;
  const void* cbf;
  const float* decode;
  uint64_t mask;   // cells - 1 (flat layouts)
  uint64_t rmask;  // rows - 1 (blocked layout)
  int num_hash;
  uint64_t kms;  // k * MULTI_SEED mod 2^64
  int k, stranded, left, lookahead, superstep_hops, max_supersteps;
};

template <typename T>
__device__ __forceinline__ T pick4(T a0, T a1, T a2, T a3, int i) {
  return i == 0 ? a0 : (i == 1 ? a1 : (i == 2 ? a2 : a3));
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return pick4(a[0], a[1], a[2], a[3], i);
}

__device__ __forceinline__ uint64_t rotl(uint64_t x, int s) {
  s &= 63;
  return s ? (x << s) | (x >> (64 - s)) : x;
}

__device__ __forceinline__ uint64_t seed_of(int c) {
  return c < 4 ? pick4(kSeed0, kSeed1, kSeed2, kSeed3, c) : 0ull;
}

// The successors of a k-mer whose first base is `out`:
//   fh' = rotl(fh,1) ^ rotl(seed[out], k) ^ seed[n]
//   rh' = rotr(rh,1) ^ rotr(seed[comp out], 1) ^ rotl(seed[comp n], k-1)
// Slide holds the part shared by the 4 children.
struct Slide {
  uint64_t tf, tr;
};

__device__ __forceinline__ Slide slide(const Walk& p, uint64_t fh, uint64_t rh, int out) {
  return {rotl(fh, 1) ^ rotl(seed_of(out), p.k), rotl(rh, 63) ^ rotl(seed_of(out < 4 ? 3 - out : out), 63)};
}

// child n of a slide; rs[n] = rotl(seed[3-n], k-1)
__device__ __forceinline__ void child(const Slide& s, int n, const uint64_t (&rs)[4], uint64_t& f,
                                      uint64_t& r) {
  f = s.tf ^ seed_of(n);
  r = s.tr ^ pick4(rs, n);
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

// raw cell i of key q (bit pattern in 32 bits)
template <int L>
__device__ __forceinline__ uint32_t load_cell(const Walk& p, uint64_t q, int i) {
  if (L == kI32Blocked) {
    const int32_t* row = (const int32_t*)p.cbf + ((q >> 1) & p.rmask) * 128;
    const uint32_t lane0 = (uint32_t)(q >> 40) & 127u;
    uint32_t lane = lane0;
    if (i > 0) {
      const uint32_t step = (uint32_t)(multi(p, q, i) & 0xFFFFFFFFull) % 127u + 1u;
      lane = (lane0 + step * (uint32_t)i) & 127u;
    }
    return (uint32_t)__ldg(row + lane);
  }
  const uint64_t idx = (multi(p, q, i) >> 1) & p.mask;
  if (L == kMf8) return __ldg((const unsigned char*)p.cbf + idx);
  if (L == kU16) return __ldg((const unsigned short*)p.cbf + idx);
  return (uint32_t)__ldg((const int32_t*)p.cbf + idx);
}

template <int L>
__device__ __forceinline__ float cell_count(const float* dec, uint32_t raw) {
  if (L == kMf8) return dec[raw];
  if (L == kU16) return __int2float_rn((int)raw);
  return __int2float_rn((int32_t)raw);
}

// count-min estimates of M keys, as float32.  Every read of a hash group
// (all num_hash cells when H > 0) is issued before any is consumed, and
// `meanwhile()` runs while the first group is in flight; keys with on[m]
// false are not read and count +inf.
template <int L, int H, int M, typename F>
__device__ __forceinline__ void count_many(const Walk& p, const float* dec, const uint64_t (&q)[M],
                                           const bool (&on)[M], float (&out)[M], F&& meanwhile) {
  constexpr int HU = H > 0 ? H : 1;
  const int nh = H > 0 ? H : p.num_hash;
#pragma unroll
  for (int m = 0; m < M; ++m) out[m] = INFINITY;
  for (int i0 = 0; i0 < nh; i0 += HU) {
    uint32_t raw[M][HU];
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int j = 0; j < HU; ++j) raw[m][j] = on[m] ? load_cell<L>(p, q[m], i0 + j) : 0u;
    }
    if (i0 == 0) meanwhile();
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int j = 0; j < HU; ++j)
        if (on[m]) out[m] = fminf(out[m], cell_count<L>(dec, raw[m][j]));
    }
  }
}

template <int L, int H, int M>
__device__ __forceinline__ void count_many(const Walk& p, const float* dec, const uint64_t (&q)[M],
                                           const bool (&on)[M], float (&out)[M]) {
  count_many<L, H, M>(p, dec, q, on, out, [] {});
}

// first index of the maximum of 4 values
__device__ __forceinline__ int argmax4(const float (&v)[4]) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < 4; ++c)
    if (v[c] > v[best]) best = c;
  return best;
}

using Tile = cg::thread_block_tile<G>;

__device__ __forceinline__ float tile_max(Tile tile, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, tile.shfl_xor(v, o));
  return v;
}

__device__ __forceinline__ unsigned tile_or(Tile tile, unsigned v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v |= tile.shfl_xor(v, o);
  return v;
}

template <int L, int H, bool kDeep>
struct Lane {
  static constexpr int M1 = (16 + G - 1) / G;  // level-1 k-mers per thread
  static constexpr int M2 = 64 / G;            // level-2 k-mers (leaves) per thread

  const Walk& p;
  Tile tile;
  const float* dec;
  int64_t* ring;  // this lane's cycle ring in shared memory
  uint8_t* buf;
  int rank;
  uint64_t rs[4];  // rotl(seed[3-n], k-1)
  int32_t pos, hops, status, bound;
  uint64_t fh, rh;
  float path_min, floor;
  int out;       // buf[pos - k]: the current k-mer's first base
  int out_next;  // buf[pos + 1 - k], loaded with the candidates
  // the 4 candidates of the current k-mer, in every thread: hashes, counts
  // and which are in the cycle ring (bit c)
  bool cached = false;
  uint64_t f4[4], r4[4], q4[4];
  float cnt[4];
  unsigned seen;

  __device__ int buf_at(int i) const {
    i = i < 0 ? 0 : (i > p.max_len - 1 ? p.max_len - 1 : i);
    return buf[i];
  }

  // the candidates' hashes; starts the load of the next first base
  __device__ void set_candidates() {
    out_next = buf_at(pos + 1 - p.k);
    const Slide s = slide(p, fh, rh, out);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      child(s, c, rs, f4[c], r4[c]);
      q4[c] = query(p, f4[c], r4[c]);
    }
  }

  // which candidates are in the cycle ring: thread r scans its slots
  __device__ void check_ring() {
    unsigned hit = 0;
    for (int j = rank; j < p.cycle_window; j += G) {
      const uint64_t v = (uint64_t)ring[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) hit |= (unsigned)(v == q4[c]) << c;
    }
    seen = tile_or(tile, hit);
  }

  // level 0: thread c < 4 reads candidate c; the ring is scanned while the
  // reads are in flight
  __device__ void read_candidates() {
    set_candidates();
    const uint64_t mine[1] = {pick4(q4, rank & 3)};
    const bool on[1] = {rank < 4};
    float got[1];
    count_many<L, H, 1>(p, dec, mine, on, got, [&] { check_ring(); });
#pragma unroll
    for (int c = 0; c < 4; ++c) cnt[c] = tile.shfl(got[0], c);
    cached = true;
  }

  __device__ void advance(int c) {
    if (rank == 0) buf[pos < p.max_len - 1 ? pos : p.max_len - 1] = (uint8_t)c;
    const int slot = (hops + 1) % p.cycle_window;
    if (slot % G == rank) ring[slot] = (int64_t)pick4(q4, c);
    fh = pick4(f4, c);
    rh = pick4(r4, c);
    path_min = fminf(path_min, pick4(cnt, c));
    ++pos;
    ++hops;
    cached = false;
    tile.sync();  // the appended byte is visible to the whole tile
    out = p.k > 1 ? out_next : buf_at(pos - p.k);
  }

  // walk_superstep's body for one ACTIVE lane
  __device__ void hop() {
    if (!cached) read_candidates();
    int nviable = 0, code = -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (cnt[c] >= floor) {
        ++nviable;
        if (code < 0) code = c;
      }
    }
    if (code < 0) code = 0;
    if (nviable == 0) {
      status = kDead;
    } else if (nviable > 1) {
      status = kBranch;  // the candidates stay cached for the resolve
    } else if ((seen >> code) & 1u) {
      status = kCycle;
    } else if (pos >= p.max_len - 1 || hops >= bound) {
      status = kFull;
    } else {
      advance(code);
    }
  }

  // greedy lookahead scores of the 4 candidates (levels 1 and deeper); only
  // viable candidates' scores are meaningful.  c1: this thread's level-1
  // counts (k-mer j = rank + G*m is child j & 3 of candidate j >> 2)
  __device__ void scores(const bool (&viable)[4], float (&s)[4], float (&c1)[M1]) {
    float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    const int out1 = out_next;  // buf[pos - k + 1]
    const int out2 = p.lookahead > 2 ? buf_at(pos - p.k + 2) : 0;
    uint64_t q1[M1];
    bool on1[M1];
#pragma unroll
    for (int m = 0; m < M1; ++m) {
      const int j = rank + G * m, c = (j >> 2) & 3;
      uint64_t f, r;
      child(slide(p, pick4(f4, c), pick4(r4, c), out1), j & 3, rs, f, r);
      q1[m] = query(p, f, r);
      on1[m] = j < 16 && pick4(viable, c);
    }
    count_many<L, H, M1>(p, dec, q1, on1, c1);
    if (p.lookahead == 2) {
#pragma unroll
      for (int m = 0; m < M1; ++m) {
        const int c = ((rank + G * m) >> 2) & 3;
        const float v = on1[m] ? fminf(pick4(cnt, c), c1[m]) : -INFINITY;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) best[cc] = cc == c ? fmaxf(best[cc], v) : best[cc];
      }
    } else {
      // level 2: leaf j = 16c + 4n1 + n2; its level-1 count comes from the
      // thread that read k-mer 4c + n1
      uint64_t fl[M2], rl[M2], q2[M2];
      bool on2[M2];
      float pm[M2], c2[M2];
#pragma unroll
      for (int m = 0; m < M2; ++m) {
        const int j = rank + G * m, c = j >> 4, j1 = j >> 2;
        uint64_t f, r;
        child(slide(p, pick4(f4, c), pick4(r4, c), out1), j1 & 3, rs, f, r);
        child(slide(p, f, r, out2), j & 3, rs, fl[m], rl[m]);
        q2[m] = query(p, fl[m], rl[m]);
        on2[m] = pick4(viable, c);
        float up = c1[0];
#pragma unroll
        for (int s1 = 0; s1 < M1; ++s1) {
          const float x = tile.shfl(c1[s1], j1 % G);
          up = s1 == j1 / G ? x : up;
        }
        pm[m] = fminf(pick4(cnt, c), up);
      }
      count_many<L, H, M2>(p, dec, q2, on2, c2);
#pragma unroll
      for (int m = 0; m < M2; ++m) pm[m] = fminf(pm[m], c2[m]);
      if (kDeep) {
        // the 64 max-count descents, one level per round
        for (int i = 0; i < p.lookahead - 3; ++i) {
          const int outc = buf_at(pos - p.k + 3 + i);
          uint64_t q3[4 * M2];
          bool on3[4 * M2];
          float c3[4 * M2];
          Slide sl[M2];
#pragma unroll
          for (int m = 0; m < M2; ++m) {
            sl[m] = slide(p, fl[m], rl[m], outc);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint64_t f, r;
              child(sl[m], n, rs, f, r);
              q3[4 * m + n] = query(p, f, r);
              on3[4 * m + n] = on2[m];
            }
          }
          count_many<L, H, 4 * M2>(p, dec, q3, on3, c3);
#pragma unroll
          for (int m = 0; m < M2; ++m) {
            const float v[4] = {c3[4 * m], c3[4 * m + 1], c3[4 * m + 2], c3[4 * m + 3]};
            const int b = argmax4(v);
            child(sl[m], b, rs, fl[m], rl[m]);
            pm[m] = fminf(pm[m], pick4(v, b));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < M2; ++m) {
        const int c = (rank + G * m) >> 4;
        const float v = on2[m] ? pm[m] : -INFINITY;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) best[cc] = cc == c ? fmaxf(best[cc], v) : best[cc];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = tile_max(tile, best[c]);
  }

  // resolve_branches(mode="greedy") for one BRANCH lane
  __device__ void resolve() {
    if (!cached) read_candidates();
    bool viable[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) viable[c] = cnt[c] >= floor;
    float s[4] = {cnt[0], cnt[1], cnt[2], cnt[3]};
    float c1[M1];
    if (p.lookahead > 1) scores(viable, s, c1);
    float top = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = viable[c] ? s[c] : -1.0f;
      top = fmaxf(top, s[c]);
    }
    float key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) key[c] = (s[c] >= top && viable[c]) ? cnt[c] : -1.0f;
    const int best = argmax4(key);
    if ((seen >> best) & 1u) {
      status = kCycle;
    } else if (pos >= p.max_len - 1) {
      status = kFull;
    } else {
      status = kActive;
      // a viable choice's children were read at level 1: they are the next
      // hop's candidates (the table does not change during a launch)
      const bool reuse = p.lookahead > 1 && viable[best] && p.k > 1;
      float kids[4];
      if (reuse) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = 4 * best + n;
          kids[n] = c1[0];
#pragma unroll
          for (int m = 0; m < M1; ++m) {
            const float x = tile.shfl(c1[m], j % G);
            kids[n] = m == j / G ? x : kids[n];
          }
        }
      }
      advance(best);
      if (reuse) {
        set_candidates();
#pragma unroll
        for (int n = 0; n < 4; ++n) cnt[n] = kids[n];
        check_ring();
        cached = true;
      }
    }
  }
};

template <int L, int H, bool kDeep>
__global__ void __launch_bounds__(kThreads, kDeep ? 1 : kBlocksPerSm) walk_greedy_kernel(Walk p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dec = (float*)smem;
  if (L == kMf8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) dec[i] = p.decode[i];
    __syncthreads();
  }
  Tile tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int tile_in_block = threadIdx.x / G;
  const int w = blockIdx.x * (blockDim.x / G) + tile_in_block;
  if (w >= p.W) return;  // the whole tile leaves together
  const int rank = tile.thread_rank();
  int64_t* ring = (int64_t*)(smem + kDecodeBytes) + (size_t)tile_in_block * p.ring_stride;
  const int64_t* hist = p.hist + (size_t)w * p.cycle_window;
  for (int j = rank; j < p.cycle_window; j += G) ring[j] = hist[j];

  Lane<L, H, kDeep> lane{p, tile, dec, ring, p.buf + (size_t)w * p.max_len, rank};
#pragma unroll
  for (int n = 0; n < 4; ++n) lane.rs[n] = rotl(seed_of(3 - n), p.k - 1);
  lane.pos = p.pos[w];
  lane.hops = p.hops[w];
  lane.status = p.status[w];
  lane.bound = p.bound[w];
  lane.fh = (uint64_t)p.fh[w];
  lane.rh = (uint64_t)p.rh[w];
  lane.path_min = p.path_min[w];
  lane.floor = fmaxf(p.min_cov[w], 1.0f);
  lane.out = lane.buf_at(lane.pos - p.k);
  for (int s = 0; s < p.max_supersteps; ++s) {
    if (lane.status != kActive && lane.status != kBranch) break;
    for (int h = 0; h < p.superstep_hops && lane.status == kActive; ++h) lane.hop();
    if (lane.status == kBranch) lane.resolve();
  }
  for (int j = rank; j < p.cycle_window; j += G) p.hist[(size_t)w * p.cycle_window + j] = ring[j];
  if (rank == 0) {
    p.pos[w] = lane.pos;
    p.hops[w] = lane.hops;
    p.status[w] = lane.status;
    p.fh[w] = (int64_t)lane.fh;
    p.rh[w] = (int64_t)lane.rh;
    p.path_min[w] = lane.path_min;
  }
}

size_t smem_bytes(int threads, int ring_stride) {
  return kDecodeBytes + (size_t)(threads / G) * ring_stride * sizeof(int64_t);
}

template <int L, int H, bool kDeep>
int launch(const Walk& p, cudaStream_t stream) {
  // fewer lanes a block when their rings would pass the default 48 KB
  int threads = kThreads;
  while (threads > G && smem_bytes(threads, p.ring_stride) > 48 * 1024) threads /= 2;
  const size_t smem = smem_bytes(threads, p.ring_stride);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(walk_greedy_kernel<L, H, kDeep>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = threads / G;
  walk_greedy_kernel<L, H, kDeep><<<(p.W + tiles - 1) / tiles, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L, bool kDeep>
int launch_hash(const Walk& p, cudaStream_t stream) {
  switch (p.num_hash) {
    case 1:
      return launch<L, 1, kDeep>(p, stream);
    case 2:
      return launch<L, 2, kDeep>(p, stream);
    case 3:
      return launch<L, 3, kDeep>(p, stream);
    default:
      return launch<L, 0, kDeep>(p, stream);
  }
}

template <int L>
int launch_layout(const Walk& p, cudaStream_t stream) {
  return p.lookahead > 3 ? launch_hash<L, true>(p, stream) : launch_hash<L, false>(p, stream);
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
  if (num_hash < 1 || lookahead < 1 || cycle_window < 1) return (int)cudaErrorInvalidValue;
  const int rows_log2 = size_log2 - 7;
  Walk p{buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound,
         W, max_len, cycle_window, cycle_window + kRingPad, cbf, decode,
         size_log2 >= 64 ? ~0ull : (1ull << size_log2) - 1,
         rows_log2 >= 32 ? 0xFFFFFFFFull : (rows_log2 > 0 ? (1ull << rows_log2) - 1 : 0ull),
         num_hash, (uint64_t)kms, k, stranded, left, lookahead, superstep_hops, max_supersteps};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (layout) {
    case kMf8:
      return launch_layout<kMf8>(p, s);
    case kU16:
      return launch_layout<kU16>(p, s);
    case kI32:
      return launch_layout<kI32>(p, s);
    case kI32Blocked:
      return launch_layout<kI32Blocked>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
