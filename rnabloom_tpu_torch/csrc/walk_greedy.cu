// De Bruijn graph walks for Hopper (sm_90a), greedy, pair and naive modes,
// bound with ctypes.
//
// Replaces the XLA while-loop of rnabloom_tpu/graph/traverse.py::
// _extend_walks_fused (mode="greedy", "pair" or "naive", back-branch checks
// in naive mode, no terminators, spec_hops = 1): supersteps of
// walk_superstep alternating with resolve_branches, until no lane is ACTIVE
// or BRANCH or max_supersteps ran.  The walk state that comes out equals the lockstep
// loop's, field for field, the pair ring included
// (graph/traverse.py::extend_walks_plain is the plain version).
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
//    fixed: 16 was no faster, 32 slower; pair mode takes 16, below).  Every thread of a tile keeps the
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
// Pair mode (the stage-3 extension, extendRightPE; the pair branch of
// rnabloom_tpu/graph/traverse.py:1032, resolve_branches(mode="pair")): a
// hop also writes the new k-mer's (fh, rh) into the lane's pair ring
// (global memory, slot pos % R), and a resolve scores the candidates by
// pair support instead of lookahead (traverse.py::_probe_with_hashes,
// ::_pair_scores).
//
// What bounds it on this card: a lane's chain of dependent rounds times
// what a round costs.  Stage 3 launches 64-2048 lanes; the longest lane of
// its first full batch walks 1,002 hops and 44 resolves, 2,058 rounds at
// one probe step a round (a hop that reads 1, a resolve D + 1 = 25).  On an
// H100 one dependent random read of the 512 MiB cbf takes about 190 ns,
// but a round of 16 threads x 2 such reads from one SM about 600 ns and of
// 16 x 10 about 820 ns, and a lane's on-chip work between two rounds (picks,
// hashes, the advance, the ring scan) takes about twice a round's wait
// for its counts (tools/pair_profile.py).  So this schedule halves the
// rounds, at about 2.5 times the reads, and trims the on-chip chain:
//
//  * A tile of 16 threads a lane; thread 4c + n.
//  * A hop's round reads the 4 candidates (threads 0-3) and their 16
//    children (thread 4c + n: child n of candidate c).  A hop that
//    advances with one viable candidate hands that candidate's 4 children
//    to the next hop as its counts: that hop costs no round.  The cycle
//    ring, the FULL checks, the pair-ring write and the append stay per
//    hop, in order.
//  * A resolve probes each candidate by a greedy naive descent of D =
//    pair_probe_depth k-mers.  Thread 4c + n reads successor n of probe
//    c's newest k-mer and that successor's 4 children, so a round takes
//    two steps: step j is the group's first maximum among the successors
//    that reach the floor (shuffles within the 4 threads), step j + 1 the
//    first maximum among the chosen successor's children, which its
//    reader holds.  Step 1 comes without a round from the children a hop
//    read.  A resolve is ceil((D - 1 - s) / 2) + 1 rounds, s = 1 when step
//    1 was known: 12 or 13 at D = 24.
//  * Thread 4c + n looks up pair class n & 1 of probe c at pending depth
//    n >> 1: the ring loads of a round's two depths and the lookups of the
//    previous round's are issued while the round's counts are in flight,
//    and a lookup's pkbf bytes are consumed a round later; the last
//    depths' lookups are a resolve's last round.
//  * The median of a candidate's live probe counts (a prefix of its
//    probe) by rank selection within its group, from shared memory, then
//    score = min(path_min, median) * (n_read + n_frag) / (last + 1) in
//    float32 with IEEE rounding (no fast math: a rounding that differs
//    from the plain version's flips picks).  The best score wins, ties to
//    the higher median, then the smaller base; no viable candidate stops
//    the lane.
//  * A resolve that advances hands its choice's step-1 counts to the next
//    hop, and, when its first round took steps 1 and 2, their children.
//  * The pair-ring and cycle-ring slots are counters: an integer modulo a
//    hop cost more than the rest of the advance.
//  * Lanes spread over every SM before any SM takes a second block, and a
//    block asks for up to 255 registers a thread (about 160, no spills).
// Pair mode is instantiated for the 4 layouts x num_hash 1-3 and the
// generic one, without the lookahead split (it reads no lookahead tree).
// kProfile = 1 builds a copy that times each phase of a lane with clock64.

// Naive mode (the -extend walks of stage 2, naiveExtendRight; the naive
// branch of traverse.py:1032 with the back-branch check): depth probes in
// place of lookahead scores.  What bounds it on this card: a lane's chain
// of dependent rounds, and on a whole batch the card's random reads.  On
// the -extend walks of a stage-2 batch (8,192 lanes, tip_probe_depth T =
// 8) most lanes stop at a branch within a few hops, the longest makes 153
// hops and 5 resolves, and the one-step schedule (a round a hop, a round a
// probe step) gave it 195 rounds at about 1.7 us each.  This schedule
// halves the rounds, at 2.5 times the reads the plain loop needs, and
// trims each round's on-chip chain (tools/pair_profile.py --naive):
//
//  * A warp a lane (kNaiveG = 32 threads), blocks of 2 lanes, up to 128
//    registers a thread: finished lanes free their block's place for the
//    next lanes (the hardware's block queue), and the 4 probes' picks run
//    side by side in the warp's 4 groups of 8.
//  * A round that reads a k-mer's candidates (threads 0-3) and its left
//    variants but itself (20-23) also reads the "kids": the candidates'
//    16 children (thread 4 + 4c + n) and each candidate's left variants
//    (12 of 16, threads 24-31 and a second k-mer of threads 0-7), each
//    thread's k-mers computed without divergent paths.  A hop that
//    advances with the kids known hands the next hop its counts and
//    whether a left variant of it is viable: that hop costs no round.  A
//    resolve that advances hands them on too.
//  * The back-branch check: every live left variant's first step departs
//    its own base to the walk's own candidates (the rolling hash cancels
//    the substituted base), so all variants follow one greedy descent
//    from the candidates (traverse.py::_variant_depth_probe); it is run
//    once, and only when a variant is viable.  Step 0 picks among the
//    candidates' counts, step 1 among the kids; then two steps a round:
//    threads 0-3 read the path's 4 successors, thread t < 16 child t & 3
//    of successor t >> 2.  A variant that reaches T stops the lane before
//    any other status.
//  * A resolve probes each candidate with a beam of 2
//    (traverse.py::_tip_probe): thread t works for probe t >> 3, beam
//    successor t & 7 (slot (t >> 2) & 1, base t & 3), and reads that
//    successor and its 4 children, so a round takes two steps: step j
//    takes the top 2 of the group's 8 successors (8 shuffles, then a scan
//    in registers in slot-major order: the first maximum, then the first
//    maximum with the first pick's score taken as -1, which is index 0
//    when every other score is -1), step j + 1 the top 2 of the two
//    picks' children, which their readers hold.  Step 0 comes from the
//    kids.  Each slot lives when its pick's own score reaches the floor;
//    a probe is deep when a slot lives after T - 1 steps (dead slots stay
//    dead); exactly one deep candidate advances, else the lane stops.
//  * A probe ends once nothing moves any more; an odd number of steps
//    ends on a one-step round.
//  * Out codes come from a window of the buffer, buf[pos - k + t] in
//    thread t, slid one base a shuffle at each advance (its new byte
//    loaded one advance ahead); the k-dependent rotations from a table
//    the host fills; the current k-mer's slide is kept; the cycle ring's
//    slot is counted, and only the chosen candidate is looked up in it.
// Naive mode is instantiated for the 4 layouts x num_hash 1-3 and the
// generic one.  chip_smoke.py phase 8 holds it to the plain loop and
// replays both schedules (naive_tally).
//
// The entry points launch on the caller's stream, do not synchronise,
// allocate nothing and return cudaGetLastError() as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int G = 8;  // threads per walk lane (greedy and naive modes)
static_assert(G >= 8 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two in [8, 32]");
constexpr int kPairG = 16;  // threads per walk lane in pair mode: 4 probes x 4 successors
constexpr int kNaiveG = 32;  // threads per walk lane in naive mode: 4 probes x 8 beam successors
constexpr int kThreads = 256;       // threads per block (fewer when rings need it)
constexpr int kBlocksPerSm = 3;     // resident blocks an SM asks for: <= 85 registers a thread
constexpr int kPairBlocksPerSm = 1;  // pair mode: up to 255 registers a thread (no spills)
constexpr int kNaiveThreads = 64;    // naive mode: 2 lanes a block, so finished lanes free their SM early
constexpr int kNaiveBlocksPerSm = 8;  // naive mode: <= 128 registers a thread
constexpr int kRingPad = 8;         // int64 slots between two lanes' rings
constexpr int kDecodeBytes = 1024;  // the mf8 decode table in shared memory

constexpr int kActive = 0;
constexpr int kBranch = 1;
constexpr int kDead = 2;
constexpr int kCycle = 3;
constexpr int kFull = 5;
constexpr int kStoppedBranch = 6;

constexpr uint64_t kPairConst = 0x9E3779B9ull;

// Pair- and naive-mode timing: with kProfile = 1 (tools/pair_profile.py
// builds such a copy) rank 0 of each lane adds clock64() spans of each
// phase to g_prof (cycles, then counts); with 0 it compiles away.
constexpr int kProfile = 0;
enum { kPfHopRead, kPfHopRest, kPfResHead, kPfResWait, kPfResStep, kPfResTail, kPfAdvance, kPfSync, kPfTake };
// naive mode (tools/pair_profile.py --naive names them in this order)
constexpr int kNvHopRead = 0, kNvHopRest = 1, kNvVarRound = 2, kNvVarWait = 3, kNvResRound = 4, kNvResWait = 5,
              kNvPick = 6, kNvCode = 7, kNvAdvance = 8, kNvResTail = 9, kNvKids = 10, kNvTake = 11, kNvResHead = 12,
              kNvRing = 13, kNvBack = 14;
constexpr int kProfSlots = 16;  // phases of either mode
__device__ unsigned long long g_prof[2 * kProfSlots];

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
  // pair mode
  int64_t* ring_fh;  // (W, R) pair ring
  int64_t* ring_rh;
  int R, D;  // ring slots, probe depth
  const uint8_t* pk[2];  // rpkbf, fpkbf lanes (null: the class is off)
  uint64_t pmask;  // pkbf lanes - 1
  int pnh;  // pkbf num_hash
  int dist[2];  // read and fragment pair distances (0: the class is off)
  // naive mode
  int T;     // tip_probe_depth
  int back;  // back-branch checks on
  uint64_t rot_k[4];  // rotl(seed[c], k), from the host
};

constexpr int kGreedy = 0;
constexpr int kPairMode = 1;
constexpr int kNaive = 2;

template <typename T>
__host__ __device__ __forceinline__ T pick4(T a0, T a1, T a2, T a3, int i) {
  return i == 0 ? a0 : (i == 1 ? a1 : (i == 2 ? a2 : a3));
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return pick4(a[0], a[1], a[2], a[3], i);
}

__host__ __device__ __forceinline__ uint64_t rotl(uint64_t x, int s) {
  s &= 63;
  return s ? (x << s) | (x >> (64 - s)) : x;
}

__host__ __device__ __forceinline__ uint64_t seed_of(int c) {
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

template <int W>
using TileOf = cg::thread_block_tile<W>;

// reductions over groups of W threads of a tile (W: the tile's width, or
// a power of two below it)
template <int W, typename T>
__device__ __forceinline__ float tile_max(T tile, float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, tile.shfl_xor(v, o));
  return v;
}

template <int W, typename T>
__device__ __forceinline__ unsigned tile_or(T tile, unsigned v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v |= tile.shfl_xor(v, o);
  return v;
}

// the first maximum of (v, i) across each group of W threads: the larger
// v, then the smaller i
template <int W, typename T>
__device__ __forceinline__ void tile_argmax(T tile, float& v, int& i) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float v2 = tile.shfl_xor(v, o);
    const int i2 = tile.shfl_xor(i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// the pair-hash combiner, a ^ (b + 0x9e3779b9 + (a << 6) + (b >>> 2))
__device__ __forceinline__ uint64_t combine(uint64_t a, uint64_t b) {
  return a ^ (b + kPairConst + (a << 6) + (b >> 2));
}

template <int L, int H, bool kDeep, int kMode>
struct Lane {
  static constexpr bool kPair = kMode == kPairMode;
  static constexpr int GT = kPair ? kPairG : (kMode == kNaive ? kNaiveG : G);  // threads per lane
  using Tile = TileOf<GT>;
  static constexpr int M1 = (16 + GT - 1) / GT;  // level-1 k-mers per thread
  static constexpr int M2 = 64 / GT;            // level-2 k-mers (leaves) per thread

  const Walk& p;
  Tile tile;
  const float* dec;
  int64_t* ring;  // this lane's cycle ring in shared memory
  uint8_t* buf;
  int rank;
  int64_t* pair_fh;  // this lane's pair ring (pair mode)
  int64_t* pair_rh;
  float* probe_cnt;  // (4, D) probe counts in shared memory (pair mode)
  uint64_t rs[4];  // rotl(seed[3-n], k-1)
  int32_t pos, hops, status, bound;
  uint64_t fh, rh;
  float path_min, floor;
  int out;       // buf[pos - k]: the current k-mer's first base
  int out_next;  // buf[pos + 1 - k], loaded with the candidates (pair mode: at each advance)
  // the 4 candidates of the current k-mer, in every thread: hashes, counts
  // and which are in the cycle ring (bit c)
  bool cached = false;
  uint64_t f4[4], r4[4], q4[4];
  float cnt[4];
  unsigned seen;
  // naive mode: whether a left variant of the current k-mer (not itself) is
  // viable; the kids' variant viability (bit 4c + v: variant v of
  // candidate c); thread t's out code buf[pos - k + t]
  bool vany = false;
  unsigned nv16 = 0;
  int win = 0;
  int nxt = 0;  // thread GT - 1's next window byte, loaded one advance ahead
  Slide cur;    // the slide of the current k-mer (its candidates' common part)
  // pair mode: thread 4c + n holds the count of child n of candidate c
  // (departing out_next) when `kids`; naive mode: thread 4 + 4c + n, and
  // nv16 holds the variants of the candidates (naive_read)
  bool kids = false;
  float kid;
  // the slots of the next pair-ring write (pos % R, pair mode) and the next
  // cycle-ring push ((hops + 1) % cycle_window, pair and naive modes),
  // counted, not divided
  int pslot, cslot;

  __device__ long long prof_now() const {
    if constexpr (kProfile && kMode != kGreedy) return clock64();
    return 0;
  }

  __device__ void prof_add(int phase, long long t0) const {
    if constexpr (kProfile && kMode != kGreedy) {
      if (rank == 0) {
        atomicAdd(&g_prof[phase], (unsigned long long)(clock64() - t0));
        atomicAdd(&g_prof[kProfSlots + phase], 1ull);
      }
    }
  }

  __device__ int buf_at(int i) const {
    i = i < 0 ? 0 : (i > p.max_len - 1 ? p.max_len - 1 : i);
    return buf[i];
  }

  // the candidates' hashes; in greedy and naive modes starts the load of
  // the next first base (pair mode loads it at each advance)
  __device__ void set_candidates() {
    if constexpr (!kPair) out_next = buf_at(pos + 1 - p.k);
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
    for (int j = rank; j < p.cycle_window; j += GT) {
      const uint64_t v = (uint64_t)ring[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) hit |= (unsigned)(v == q4[c]) << c;
    }
    seen = tile_or<GT>(tile, hit);
  }

  // level 0: thread c < 4 reads candidate c; the ring is scanned while the
  // reads are in flight
  __device__ void read_candidates() {
    set_candidates();
    if constexpr (kPair) {
      // the 4 candidates (threads 0-3) and their 16 children (thread 4c + n:
      // child n of candidate c) in one round; the ring is scanned meanwhile
      const int c = rank >> 2;
      uint64_t f, r;
      child(slide(p, pick4(f4, c), pick4(r4, c), out_next), rank & 3, rs, f, r);
      const uint64_t q[2] = {query(p, f, r), pick4(q4, rank & 3)};
      const bool on[2] = {true, rank < 4};
      float got[2];
      count_many<L, H, 2>(p, dec, q, on, got, [&] { check_ring(); });
#pragma unroll
      for (int n = 0; n < 4; ++n) cnt[n] = tile.shfl(got[1], n);
      kid = got[0];
      kids = cached = true;
      return;
    }
    const uint64_t mine[1] = {pick4(q4, rank & 3)};
    const bool on[1] = {rank < 4};
    float got[1];
    count_many<L, H, 1>(p, dec, mine, on, got, [&] { check_ring(); });
#pragma unroll
    for (int c = 0; c < 4; ++c) cnt[c] = tile.shfl(got[0], c);
    cached = true;
  }

  __device__ void advance(int c) {
    const long long t0 = prof_now();
    if (rank == 0) buf[pos < p.max_len - 1 ? pos : p.max_len - 1] = (uint8_t)c;
    if (kPair && rank == 0) {  // the new k-mer ends at the old pos: slot pos % R
      pair_fh[pslot] = (int64_t)pick4(f4, c);
      pair_rh[pslot] = (int64_t)pick4(r4, c);
    }
    const int slot = kPair ? cslot : (hops + 1) % p.cycle_window;
    if (slot % GT == rank) ring[slot] = (int64_t)pick4(q4, c);
    fh = pick4(f4, c);
    rh = pick4(r4, c);
    path_min = fminf(path_min, pick4(cnt, c));
    ++pos;
    ++hops;
    cached = false;
    const long long ts = prof_now();
    tile.sync();  // the appended byte is visible to the whole tile
    prof_add(kPfSync, ts);
    if constexpr (kPair) {
      // both written: pair mode has k > D >= 1
      out = out_next;
      out_next = buf_at(pos + 1 - p.k);
      kids = false;
      pslot = pslot + 1 == p.R ? 0 : pslot + 1;
      cslot = cslot + 1 == p.cycle_window ? 0 : cslot + 1;
    } else {
      out = p.k > 1 ? out_next : buf_at(pos - p.k);
    }
    prof_add(kPfAdvance, t0);
  }

  // the candidates of the k-mer just advanced to, with their counts known
  // (read in an earlier round)
  __device__ void take_candidates(const float (&known)[4]) {
    const long long t0 = prof_now();
    set_candidates();
#pragma unroll
    for (int n = 0; n < 4; ++n) cnt[n] = known[n];
    check_ring();
    cached = true;
    prof_add(kPfTake, t0);
  }

  // walk_superstep's body for one ACTIVE lane
  __device__ void hop() {
    long long t0 = prof_now();
    if (!cached) {
      read_candidates();
      prof_add(kPfHopRead, t0);
      t0 = prof_now();
    }
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
    } else if constexpr (kPair) {
      // the choice's children were read with the candidates: they are the
      // next hop's candidates, which then costs no round
      const bool hand = kids;
      float next[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) next[n] = tile.shfl(kid, 4 * code + n);
      advance(code);
      if (hand) take_candidates(next);
    } else {
      advance(code);
    }
    prof_add(kPfHopRest, t0);
  }

  // ---- naive mode (the head comment states the schedule) ----

  // buf[pos - k + i] for a tile-uniform i >= 0: from the window while it
  // holds it
  __device__ int code_at(int i) const {
    if (i < GT) return tile.shfl(win, i);
    return buf_at(pos - p.k + i);
  }

  // slide(): the k-dependent rotation from the launch's table
  __device__ Slide nslide(uint64_t f, uint64_t r, int o) const {
    return {rotl(f, 1) ^ (o < 4 ? p.rot_k[o] : 0ull), rotl(r, 63) ^ rotl(seed_of(o < 4 ? 3 - o : o), 63)};
  }

  // candidate c of the current k-mer
  __device__ void cand(int c, uint64_t& f, uint64_t& r) const { child(cur, c, rs, f, r); }

  // left variant v of the k-mer (f, r) whose first base is `first`: the
  // first base substituted, rotation k-1 forward (rs[3 - b] = rotl(seed[b],
  // k-1)), the complement's rotation 0 on the reverse strand
  __device__ uint64_t variant_query(uint64_t f, uint64_t r, int first, int v) const {
    const uint64_t vf = f ^ (first < 4 ? pick4(rs, 3 - first) : 0ull) ^ pick4(rs, 3 - v);
    const uint64_t vr = r ^ seed_of(first < 4 ? 3 - first : first) ^ seed_of(3 - v);
    return query(p, vf, vr);
  }

  // is candidate c in the cycle ring?  Thread r scans its slots.
  __device__ bool in_ring(int c) const {
    const long long t0 = prof_now();
    uint64_t f, r;
    cand(c, f, r);
    const uint64_t q = query(p, f, r);
    bool hit = false;
    for (int j = rank; j < p.cycle_window; j += GT) hit |= (uint64_t)ring[j] == q;
    hit = tile.any(hit);
    prof_add(kNvRing, t0);
    return hit;
  }

  // A round that reads the kids: the candidates' 16 children (thread 4 +
  // 4c + n: child n of candidate c) and, with back-branch checks, each
  // candidate's left variants but itself (thread 24 + u, u < 8, and thread
  // u - 8, u >= 8: variant u & 3 of candidate u >> 2).  Unless `known`,
  // also the candidates (threads 0-3) and the k-mer's left variants but
  // itself (threads 20-23).
  __device__ void naive_read(bool known) {
    const long long t0 = prof_now();
    const int t = rank, n = t & 3;
    // every thread computes each kind of k-mer and keeps its own (no
    // divergent paths): candidate, child, own variant or a candidate's
    const bool kc = t < 4, kchild = t >= 4 && t < 20, kown = t >= 20 && t < 24;
    uint64_t f, r, cf, cr, q[2];
    cand(kc ? t : ((t - (kchild ? 4 : 24)) >> 2) & 3, f, r);
    child(nslide(f, r, out_next), n, rs, cf, cr);
    const uint64_t vq = variant_query(kown ? fh : f, kown ? rh : r, kown ? out : out_next, n);
    q[0] = kc ? query(p, f, r) : (kchild ? query(p, cf, cr) : vq);
    cand(2 + ((t >> 2) & 1), f, r);  // thread t < 8: variant n of candidate 2 + (t >> 2)
    q[1] = variant_query(f, r, out_next, n);
    const bool on[2] = {kc ? !known : (kown ? p.back && !known && n != out : kchild || (p.back && n != out_next)),
                        t < 8 && p.back && n != out_next};
    float got[2];
    count_many<L, H, 2>(p, dec, q, on, got);
    const unsigned a = tile.ballot(on[0] && got[0] >= floor), b = tile.ballot(on[1] && got[1] >= floor);
    if (!known) {
#pragma unroll
      for (int c = 0; c < 4; ++c) cnt[c] = tile.shfl(got[0], c);
      vany = ((a >> 20) & 0xFu) != 0;
    }
    nv16 = ((a >> 24) & 0xFFu) | ((b & 0xFFu) << 8);
    kid = got[0];
    cached = kids = true;
    prof_add(known ? kNvKids : kNvHopRead, t0);
  }

  // the naive advance to candidate c, with cnt[c] known: the append, the
  // ring push at its counted slot, the window slid one base (the appended
  // base lands at k - 1); with the kids known, the next hop's counts and
  // variant viability handed on
  __device__ void advance_naive(int c) {
    const long long t0 = prof_now();
    uint64_t f, r;
    cand(c, f, r);
    const int old = pos;
    if (rank == 0) buf[old < p.max_len - 1 ? old : p.max_len - 1] = (uint8_t)c;
    if ((cslot & (GT - 1)) == rank) ring[cslot] = (int64_t)query(p, f, r);
    cslot = cslot + 1 == p.cycle_window ? 0 : cslot + 1;
    fh = f;
    rh = r;
    path_min = fminf(path_min, pick4(cnt, c));
    ++pos;
    ++hops;
    const bool hand = kids;
    float next[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) next[n] = tile.shfl(kid, 4 + 4 * c + n);
    vany = ((nv16 >> (4 * c)) & 0xFu) != 0;
    tile.sync();  // the appended byte is visible to the whole tile
    int w = tile.shfl_down(win, 1);
    if (rank == GT - 1) w = nxt;  // loaded at the last advance: never the byte just appended but for k = GT
    if (rank == p.k - 1) w = c;
    win = w;
    if (old == 0) win = buf_at(pos - p.k + rank);  // a window reaching before the buffer reloads
    nxt = buf_at(pos - p.k + GT);
    out = tile.shfl(win, 0);
    out_next = tile.shfl(win, 1);
    cur = nslide(fh, rh, out);
#pragma unroll
    for (int n = 0; n < 4; ++n) cnt[n] = next[n];
    cached = hand;
    kids = false;
    prof_add(hand ? kNvTake : kNvAdvance, t0);
  }

  // the first maximum of 4 scores (count, or -1 below the floor): the
  // picked index and whether it reaches the floor
  __device__ int pick_floor(const float (&v)[4], bool& alive) const {
    float s[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n] = v[n] >= floor ? v[n] : -1.0f;
    const int b = argmax4(s);
    alive = pick4(s, b) >= 0.0f;
    return b;
  }

  // the back-branch check of the current k-mer (cnt and vany known): does
  // a left variant other than the k-mer itself reach tip_probe_depth?
  // Every live variant's first step departs its own base to the walk's own
  // candidates, so all of them follow one greedy descent from the
  // candidates: step 0 picks among their counts, step 1 among the kids,
  // steps 2.. two a round.
  __device__ bool back_naive() {
    const int T = p.T;
    if (T <= 0) return true;  // every depth reaches it
    if (!vany) return false;
    if (T == 1) return true;
    bool alive;
    const int b0 = pick_floor(cnt, alive);
    if (!alive || T == 2) return alive;
    if (!kids) naive_read(true);
    long long t0 = prof_now();
    float k4[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) k4[n] = tile.shfl(kid, 4 + 4 * b0 + n);
    const int b1 = pick_floor(k4, alive);
    if (!alive) return false;
    uint64_t pf, pr;
    cand(b0, pf, pr);
    child(nslide(pf, pr, out_next), b1, rs, pf, pr);
    prof_add(kNvPick, t0);
    const int t = rank;
    for (int i = 2; i <= T - 2; i += 2) {
      t0 = prof_now();
      const bool two = i + 1 <= T - 2;
      const long long tc = prof_now();
      const int o0 = code_at(i), o1 = code_at(i + 1);
      prof_add(kNvCode, tc);
      // thread t < 16: child t & 3 of successor t >> 2; thread t < 4 also
      // successor t
      const Slide sp = nslide(pf, pr, o0);
      uint64_t sf, sr, f, r, q[2];
      child(sp, (t >> 2) & 3, rs, sf, sr);
      child(nslide(sf, sr, o1), t & 3, rs, f, r);
      q[0] = query(p, f, r);
      child(sp, t & 3, rs, f, r);
      q[1] = query(p, f, r);
      const bool on[2] = {two && t < 16, t < 4};
      float got[2];
      const long long tw = prof_now();
      count_many<L, H, 2>(p, dec, q, on, got);
      prof_add(kNvVarWait, tw);
      const long long ta = prof_now();
      float v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = tile.shfl(got[1], n);
      const int bi = pick_floor(v, alive);
      if (alive) {
        child(sp, bi, rs, pf, pr);
        if (two) {
#pragma unroll
          for (int m = 0; m < 4; ++m) v[m] = tile.shfl(got[0], 4 * bi + m);
          const int bj = pick_floor(v, alive);
          child(nslide(pf, pr, o1), bj, rs, pf, pr);
        }
      }
      prof_add(kNvPick, ta);
      prof_add(kNvVarRound, t0);
      if (!alive) return false;
    }
    return true;
  }

  // walk_superstep's body for one ACTIVE lane, naive mode
  __device__ void hop_naive() {
    if (!cached) naive_read(false);
    const long long t0 = prof_now();
    int nviable = 0, code = -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (cnt[c] >= floor) {
        ++nviable;
        if (code < 0) code = c;
      }
    }
    if (code < 0) code = 0;
    const long long tb = prof_now();
    const bool stop = p.back && back_naive();
    prof_add(kNvBack, tb);
    if (stop) {
      status = kStoppedBranch;
    } else if (nviable == 0) {
      status = kDead;
    } else if (nviable > 1) {
      status = kBranch;  // the candidates (and kids) stay known for the resolve
    } else if (in_ring(code)) {
      status = kCycle;
    } else if (pos >= p.max_len - 1 || hops >= bound) {
      status = kFull;
    } else {
      advance_naive(code);
    }
    prof_add(kNvHopRest, t0);
  }

  // the first and the second pick of a beam step over 8 scores in
  // slot-major order (count, or -1 below the floor or from a dead slot):
  // the first maximum, then the first maximum with the first pick's score
  // taken as -1 (index 0 when every other score is -1, the first pick
  // itself when that is 0); each slot lives when its pick's own score
  // does (traverse.py::_tip_probe)
  __device__ static void top2(const float (&v)[8], int& i1, bool& a1, int& i2, bool& a2) {
    float top = v[0];
    i1 = 0;
#pragma unroll
    for (int e = 1; e < 8; ++e) {
      if (v[e] > top) {
        top = v[e];
        i1 = e;
      }
    }
    float b = -INFINITY, own = -1.0f;
    i2 = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = e == i1 ? -1.0f : v[e];
      if (x > b) {
        b = x;
        i2 = e;
        own = v[e];
      }
    }
    a1 = top >= 0.0f;
    a2 = own >= 0.0f;
  }

  // resolve_branches(mode="naive") for one BRANCH lane: thread t works for
  // probe c = t >> 3, beam successor s = t & 7 (slot s >> 2, base s & 3)
  __device__ void resolve_naive() {
    long long t0 = prof_now();
    if (!cached) naive_read(false);
    const int T = p.T;
    const int c = rank >> 3, s = rank & 7, g = rank & ~7;
    bool a0 = pick4(cnt, c) >= floor, a1 = false;  // the probe's slots
    bool deep = T <= 0 || (T == 1 && a0);
    if (T >= 2) {
      if (!kids) naive_read(true);
      // slot hashes (a dead slot's hash is never read)
      uint64_t f0, r0, f1, r1;
      cand(c, f0, r0);
      // step 0 from the kids: the children of candidate c (slot 1 dead)
      float v[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float x = tile.shfl(kid, 4 + 4 * c + n);
        v[n] = a0 && x >= floor ? x : -1.0f;
        v[4 + n] = -1.0f;
      }
      int i1, i2;
      top2(v, i1, a0, i2, a1);
      {
        const Slide s0 = nslide(f0, r0, out_next);
        child(s0, i2 & 3, rs, f1, r1);
        child(s0, i1 & 3, rs, f0, r0);
      }
      prof_add(kNvResHead, t0);
      for (int j = 1; j <= T - 2 && tile.any(a0 || a1); j += 2) {
        t0 = prof_now();
        const bool two = j + 1 <= T - 2;
        const long long tc = prof_now();
        const int o0 = code_at(1 + j), o1 = code_at(2 + j);  // steps j, j + 1 depart these
        prof_add(kNvCode, tc);
        const bool mine = s >> 2 ? a1 : a0;
        uint64_t sf, sr, q[5];
        child(nslide(s >> 2 ? f1 : f0, s >> 2 ? r1 : r0, o0), s & 3, rs, sf, sr);
        q[0] = query(p, sf, sr);
        const Slide s2 = nslide(sf, sr, o1);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint64_t f, r;
          child(s2, m, rs, f, r);
          q[1 + m] = query(p, f, r);
        }
        const bool on[5] = {mine, mine && two, mine && two, mine && two, mine && two};
        float got[5];
        const long long tw = prof_now();
        count_many<L, H, 5>(p, dec, q, on, got);
        prof_add(kNvResWait, tw);
        const long long ta = prof_now();
        // step j: the group's 8 successors
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = tile.shfl(got[0], g | e);
          v[e] = (e >> 2 ? a1 : a0) && x >= floor ? x : -1.0f;
        }
        bool b0, b1;
        top2(v, i1, b0, i2, b1);
        uint64_t nf0, nr0, nf1, nr1;
        child(nslide(i1 >> 2 ? f1 : f0, i1 >> 2 ? r1 : r0, o0), i1 & 3, rs, nf0, nr0);
        child(nslide(i2 >> 2 ? f1 : f0, i2 >> 2 ? r1 : r0, o0), i2 & 3, rs, nf1, nr1);
        if (two) {
          // step j + 1: the children of the two picks, which their readers hold
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float x = tile.shfl(got[1 + m], g | i1), y = tile.shfl(got[1 + m], g | i2);
            v[m] = b0 && x >= floor ? x : -1.0f;
            v[4 + m] = b1 && y >= floor ? y : -1.0f;
          }
          top2(v, i1, a0, i2, a1);
          const Slide n0 = nslide(nf0, nr0, o1), n1 = nslide(nf1, nr1, o1);
          child(i1 >> 2 ? n1 : n0, i1 & 3, rs, f0, r0);
          child(i2 >> 2 ? n1 : n0, i2 & 3, rs, f1, r1);
        } else {
          a0 = b0;
          a1 = b1;
          f0 = nf0;
          r0 = nr0;
          f1 = nf1;
          r1 = nr1;
        }
        prof_add(kNvPick, ta);
        prof_add(kNvResRound, t0);
      }
      t0 = prof_now();
      deep = a0 || a1;  // alive after every step (dead slots stay dead)
    }
    const unsigned dm = tile.ballot(s == 0 && deep);  // bit 8c: probe c is deep
    int ndeep = 0;
    float key[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool d = (dm >> (8 * b)) & 1u;
      ndeep += d ? 1 : 0;
      key[b] = d ? cnt[b] : -1.0f;
    }
    const int best = argmax4(key);
    if (in_ring(best)) {
      status = kCycle;
    } else if (pos >= p.max_len - 1) {
      status = kFull;
    } else if (ndeep != 1) {
      status = kStoppedBranch;
    } else {
      status = kActive;
      advance_naive(best);
    }
    prof_add(kNvResTail, t0);
  }

  // greedy lookahead scores of the 4 candidates (levels 1 and deeper); only
  // viable candidates' scores are meaningful.  c1: this thread's level-1
  // counts (k-mer j = rank + GT*m is child j & 3 of candidate j >> 2)
  __device__ void scores(const bool (&viable)[4], float (&s)[4], float (&c1)[M1]) {
    float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    const int out1 = out_next;  // buf[pos - k + 1]
    const int out2 = p.lookahead > 2 ? buf_at(pos - p.k + 2) : 0;
    uint64_t q1[M1];
    bool on1[M1];
#pragma unroll
    for (int m = 0; m < M1; ++m) {
      const int j = rank + GT * m, c = (j >> 2) & 3;
      uint64_t f, r;
      child(slide(p, pick4(f4, c), pick4(r4, c), out1), j & 3, rs, f, r);
      q1[m] = query(p, f, r);
      on1[m] = j < 16 && pick4(viable, c);
    }
    count_many<L, H, M1>(p, dec, q1, on1, c1);
    if (p.lookahead == 2) {
#pragma unroll
      for (int m = 0; m < M1; ++m) {
        const int c = ((rank + GT * m) >> 2) & 3;
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
        const int j = rank + GT * m, c = j >> 4, j1 = j >> 2;
        uint64_t f, r;
        child(slide(p, pick4(f4, c), pick4(r4, c), out1), j1 & 3, rs, f, r);
        child(slide(p, f, r, out2), j & 3, rs, fl[m], rl[m]);
        q2[m] = query(p, fl[m], rl[m]);
        on2[m] = pick4(viable, c);
        float up = c1[0];
#pragma unroll
        for (int s1 = 0; s1 < M1; ++s1) {
          const float x = tile.shfl(c1[s1], j1 % GT);
          up = s1 == j1 / GT ? x : up;
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
        const int c = (rank + GT * m) >> 4;
        const float v = on2[m] ? pm[m] : -INFINITY;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) best[cc] = cc == c ? fmaxf(best[cc], v) : best[cc];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = tile_max<GT>(tile, best[c]);
  }

  // the pair key of (probe k-mer hf/hr, its partner qf/qr), as
  // traverse.py::_pair_scores forms it (left and right walks agree when
  // not stranded)
  __device__ uint64_t pair_key(uint64_t hf, uint64_t hr, uint64_t qf, uint64_t qr) const {
    if (p.stranded) return p.left ? combine(hr, qr) : combine(qf, hf);
    const uint64_t a = combine(qf, hf), b = combine(hr, qr);
    return (int64_t)a < (int64_t)b ? a : b;
  }

  // resolve_branches(mode="pair") for one BRANCH lane.  Thread 4c + n works
  // for probe c: it reads successor n of the probe's newest k-mer and that
  // successor's 4 children, so a round takes two probe steps; its lookups
  // are those of pair class n & 1 at pending depth n >> 1.
  __device__ void resolve_pair() {
    long long t0 = prof_now();
    if (!cached) read_candidates();
    const int D = p.D;
    const int c = rank >> 2, n = rank & 3;
    const int cls = n & 1, ds = n >> 1;
    const int dist = cls ? p.dist[1] : p.dist[0];
    const uint8_t* lanes = cls ? p.pk[1] : p.pk[0];
    bool viable[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) viable[b] = cnt[b] >= floor;
    // probe c's newest k-mer and whether it is live (the same in the group)
    bool alive = pick4(viable, c);
    uint64_t hf = pick4(f4, c), hr = pick4(r4, c);
    float* pc = probe_cnt + c * D;
    if (n == 0) pc[0] = pick4(cnt, c);
    int nv = alive ? 1 : 0;  // live depths
    // the depths whose lookups are pending (np of them from da), their
    // k-mers and liveness
    int da = 0, np = 1;
    uint64_t pf0 = hf, pr0 = hr, pf1 = 0, pr1 = 0;
    bool pal0 = alive, pal1 = false;
    // step 1's count of successor n of probe c and its children's: the next
    // hop's candidates (and their children) if c is the choice
    const bool had_kids = kids;
    float c1 = kid, g1[4] = {INFINITY, INFINITY, INFINITY, INFINITY};

    // step j from this thread's successor count v (successor n of the probe
    // k-mer, departing o): the group's first maximum among the successors
    // that reach the floor
    auto step = [&](int at, float v, int o) {
      float key = alive && v >= floor ? v : -1.0f;
      int b = n;
      tile_argmax<4>(tile, key, b);
      alive = alive && key >= 0.0f;
      if (alive) {
        child(slide(p, hf, hr, o), b, rs, hf, hr);
        ++nv;
        if (n == 0) pc[at] = key;
      }
      return b;
    };
    int j = 1;
    if (had_kids && D > 1) {  // step 1 from the children read with the candidates
      step(1, kid, out_next);
      pf1 = hf;
      pr1 = hr;
      pal1 = alive;
      np = 2;
      j = 2;
    }

    // this thread's partner at depth d: the k-mer ending at pos - dist + d,
    // when the ring still holds it
    auto partner = [&](int d, uint64_t& qf, uint64_t& qr) {
      const int end = pos - dist + d;
      const bool reach = dist > 0 && end >= p.k - 1 && pos - end < p.R;
      qf = reach ? (uint64_t)__ldcg((const long long*)pair_fh + end % p.R) : 0ull;
      qr = reach ? (uint64_t)__ldcg((const long long*)pair_rh + end % p.R) : 0ull;
      return reach;
    };
    uint64_t qf, qr;
    bool reach = ds < np && partner(ds, qf, qr);
    // a lookup's first 4 lane bytes are consumed a round after they are
    // issued (settle), so the pkbf reads overlap the next count reads
    int nsup = 0, last = -1;
    bool reach_any = false, pend = false;
    int pend_d = 0;
    uint8_t pb[4];
    auto settle = [&] {
      if (pend && pb[0] && pb[1] && pb[2] && pb[3]) {
        ++nsup;
        last = pend_d;
      }
      pend = false;
    };
    auto lookup = [&] {
      const bool on = reach && ds < np && (ds ? pal1 : pal0);
      reach_any |= on;
      if (!on) return;
      const uint64_t key = pair_key(ds ? pf1 : pf0, ds ? pr1 : pr0, qf, qr);
#pragma unroll
      for (int i = 0; i < 4; ++i) pb[i] = i < p.pnh ? __ldg(lanes + ((multi(p, key, i) >> 1) & p.pmask)) : 1;
      bool all = true;
      for (int i = 4; i < p.pnh; ++i) all &= __ldg(lanes + ((multi(p, key, i) >> 1) & p.pmask)) != 0;
      pend = all;
      pend_d = da + ds;
    };

    int o0 = buf_at(pos - p.k + j), o1 = buf_at(pos - p.k + j + 1);  // steps j and j + 1 depart these
    prof_add(kPfResHead, t0);
    while (j < D) {
      t0 = prof_now();
      const bool two = j + 1 < D;
      uint64_t sf, sr, q[5];
      bool on[5];
      child(slide(p, hf, hr, o0), n, rs, sf, sr);
      q[0] = query(p, sf, sr);
      on[0] = alive;
      const Slide s2 = slide(p, sf, sr, o1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint64_t f, r;
        child(s2, m, rs, f, r);
        q[1 + m] = query(p, f, r);
        on[1 + m] = alive && two;
      }
      float got[5];
      uint64_t nqf = 0, nqr = 0;
      bool nreach;
      int no0, no1;
      // while the counts are in flight: the next round's out codes, the
      // partners of this round's depths, the lookups of the last round's
      const long long tw = prof_now();
      count_many<L, H, 5>(p, dec, q, on, got, [&] {
        no0 = buf_at(pos - p.k + j + 2);
        no1 = buf_at(pos - p.k + j + 3);
        nreach = (ds == 0 || two) && partner(j + ds, nqf, nqr);
        settle();
        lookup();
      });
      prof_add(kPfResWait, tw);
      if (j == 1) {
        c1 = got[0];
#pragma unroll
        for (int m = 0; m < 4; ++m) g1[m] = got[1 + m];
      }
      const int b = step(j, got[0], o0);
      pf0 = hf;
      pr0 = hr;
      pal0 = alive;
      da = j;
      np = 1;
      if (two) {
        // step j + 1 among the children of the pick, which its reader holds
        float k2[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) k2[m] = got[1 + m] >= floor ? got[1 + m] : -1.0f;
        int b2 = argmax4(k2);
        const int src = (rank & ~3) | b;
        const float kb2 = tile.shfl(pick4(k2, b2), src);
        b2 = tile.shfl(b2, src);
        alive = alive && kb2 >= 0.0f;
        if (alive) {
          child(slide(p, hf, hr, o1), b2, rs, hf, hr);
          ++nv;
          if (n == 0) pc[j + 1] = kb2;
        }
        pf1 = hf;
        pr1 = hr;
        pal1 = alive;
        np = 2;
      }
      qf = nqf;
      qr = nqr;
      reach = nreach;
      o0 = no0;
      o1 = no1;
      j += two ? 2 : 1;
      prof_add(kPfResStep, t0);
    }
    t0 = prof_now();
    settle();
    lookup();
    settle();
    tile.sync();  // the probe counts are in shared memory

    // per probe: support and depth of both classes (threads n ^ 2 hold the
    // class's other depths, n ^ 1 the other class), the median of the live
    // probe counts by rank selection within the group
    const int ns = nsup + tile.shfl_xor(nsup, 2), ls = max(last, tile.shfl_xor(last, 2));
    const int ra = (int)reach_any | tile.shfl_xor((int)reach_any, 2);
    const int ns_o = tile.shfl_xor(ns, 1), ra_o = tile.shfl_xor(ra, 1);
    const int lst = max(ls, tile.shfl_xor(ls, 1));
    const int nr = cls ? ns_o : ns, nf = cls ? ns : ns_o;
    const bool rr = (cls ? ra_o : ra) != 0, rf = (cls ? ra : ra_o) != 0;
    const int half = nv / 2;
    const int lo = nv % 2 == 0 ? max(half - 1, 0) : half;
    float vlo = -INFINITY, vhalf = -INFINITY;
    for (int i = n; i < nv; i += 4) {
      const float vi = pc[i];
      int r = 0;
      for (int t = 0; t < nv; ++t) r += (pc[t] < vi) || (t < i && pc[t] == vi);
      vlo = r == lo ? vi : vlo;
      vhalf = r == half ? vi : vhalf;
    }
    vlo = tile_max<4>(tile, vlo);
    vhalf = tile_max<4>(tile, vhalf);
    const float med = nv > 0 ? __fdiv_rn(__fadd_rn(vlo, vhalf), 2.0f) : 0.0f;
    const bool ok = lst >= 0 && (!rr || nr > 0) && (!rf || nf > 0) && (rr || rf);
    const float sc = ok && pick4(viable, c)
                         ? __fdiv_rn(__fmul_rn(fminf(path_min, med), __int2float_rn(nr + nf)),
                                     __int2float_rn(max(lst + 1, 1)))
                         : -1.0f;
    float score[4], meds[4];
    float top = -INFINITY;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      score[b] = tile.shfl(sc, 4 * b);
      meds[b] = tile.shfl(med, 4 * b);
      top = fmaxf(top, score[b]);
    }
    float key[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) key[b] = score[b] >= top ? meds[b] : -1.0f;
    const int best = argmax4(key);
    tile.sync();  // the probe counts are read before a later resolve writes them
    if ((seen >> best) & 1u) {
      status = kCycle;
    } else if (pos >= p.max_len - 1) {
      status = kFull;
    } else if (!(top >= 0.0f)) {
      status = kStoppedBranch;
    } else {
      status = kActive;
      // the choice's successors were read at step 1 (with the candidates or
      // in the first round), their children in a first round of two steps:
      // the next hop's candidates and their children
      const bool reuse = had_kids || D > 1, more = !had_kids && D > 2;
      float next[4], nk = INFINITY;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        next[m] = tile.shfl(c1, 4 * best + m);
        const float x = tile.shfl(g1[m], 4 * best + c);
        nk = m == n ? x : nk;
      }
      advance(best);
      if (reuse) take_candidates(next);
      if (more) {
        kid = nk;
        kids = true;
      }
    }
    prof_add(kPfResTail, t0);
  }

  __device__ void resolve() {
    if constexpr (kMode == kPairMode) {
      resolve_pair();
    } else if constexpr (kMode == kNaive) {
      resolve_naive();
    } else {
      resolve_greedy();
    }
  }

  // resolve_branches(mode="greedy") for one BRANCH lane
  __device__ void resolve_greedy() {
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
            const float x = tile.shfl(c1[m], j % GT);
            kids[n] = m == j / GT ? x : kids[n];
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

template <int L, int H, bool kDeep, int kMode>
__global__ void __launch_bounds__(kMode == kNaive ? kNaiveThreads : kThreads,
                                  kMode == kPairMode ? kPairBlocksPerSm
                                                     : (kMode == kNaive ? kNaiveBlocksPerSm
                                                                        : (kDeep ? 1 : kBlocksPerSm)))
    walk_greedy_kernel(Walk p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dec = (float*)smem;
  if (L == kMf8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) dec[i] = p.decode[i];
    __syncthreads();
  }
  constexpr int GT = Lane<L, H, kDeep, kMode>::GT;
  TileOf<GT> tile = cg::tiled_partition<GT>(cg::this_thread_block());
  const int tile_in_block = threadIdx.x / GT;
  const int w = blockIdx.x * (blockDim.x / GT) + tile_in_block;
  if (w >= p.W) return;  // the whole tile leaves together
  const int rank = tile.thread_rank();
  int64_t* rings = (int64_t*)(smem + kDecodeBytes);
  int64_t* ring = rings + (size_t)tile_in_block * p.ring_stride;
  const int64_t* hist = p.hist + (size_t)w * p.cycle_window;
  for (int j = rank; j < p.cycle_window; j += GT) ring[j] = hist[j];

  Lane<L, H, kDeep, kMode> lane{p, tile, dec, ring, p.buf + (size_t)w * p.max_len, rank};
  if (kMode == kPairMode) {
    lane.pair_fh = p.ring_fh + (size_t)w * p.R;
    lane.pair_rh = p.ring_rh + (size_t)w * p.R;
    lane.probe_cnt = (float*)(rings + (size_t)(blockDim.x / GT) * p.ring_stride) + (size_t)tile_in_block * 4 * p.D;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) lane.rs[n] = rotl(seed_of(3 - n), p.k - 1);
  lane.pos = p.pos[w];
  lane.hops = p.hops[w];
  if (kMode == kPairMode) lane.pslot = lane.pos % p.R;
  if (kMode != kGreedy) lane.cslot = (lane.hops + 1) % p.cycle_window;
  if (kMode == kNaive) {
    lane.win = lane.buf_at(lane.pos - p.k + rank);
    lane.nxt = lane.buf_at(lane.pos - p.k + kNaiveG);
  }
  lane.status = p.status[w];
  lane.bound = p.bound[w];
  lane.fh = (uint64_t)p.fh[w];
  lane.rh = (uint64_t)p.rh[w];
  lane.path_min = p.path_min[w];
  lane.floor = fmaxf(p.min_cov[w], 1.0f);
  lane.out = lane.buf_at(lane.pos - p.k);
  if (kMode != kGreedy) lane.out_next = lane.buf_at(lane.pos + 1 - p.k);
  if (kMode == kNaive) lane.cur = lane.nslide(lane.fh, lane.rh, lane.out);
  for (int s = 0; s < p.max_supersteps; ++s) {
    if (lane.status != kActive && lane.status != kBranch) break;
    for (int h = 0; h < p.superstep_hops && lane.status == kActive; ++h) {
      if constexpr (kMode == kNaive) {
        lane.hop_naive();
      } else {
        lane.hop();
      }
    }
    if (lane.status == kBranch) lane.resolve();
  }
  for (int j = rank; j < p.cycle_window; j += GT) p.hist[(size_t)w * p.cycle_window + j] = ring[j];
  if (rank == 0) {
    p.pos[w] = lane.pos;
    p.hops[w] = lane.hops;
    p.status[w] = lane.status;
    p.fh[w] = (int64_t)lane.fh;
    p.rh[w] = (int64_t)lane.rh;
    p.path_min[w] = lane.path_min;
  }
}

// a block's shared memory: the mf8 decode table, each tile's cycle ring
// and, in pair mode, each tile's probe counts
size_t smem_bytes(const Walk& p, int threads, int gt, bool pair) {
  const size_t tiles = threads / gt;
  return kDecodeBytes + tiles * p.ring_stride * sizeof(int64_t) + (pair ? tiles * 4 * p.D * sizeof(float) : 0);
}

template <int L, int H, bool kDeep, int kMode>
int launch(const Walk& p, cudaStream_t stream) {
  const bool pair = kMode == kPairMode;
  constexpr int GT = Lane<L, H, kDeep, kMode>::GT;
  // fewer lanes a block when their shared memory would pass the default 48 KB
  int threads = kMode == kNaive ? kNaiveThreads : kThreads;
  while (threads > GT && smem_bytes(p, threads, GT, pair) > 48 * 1024) threads /= 2;
  if (pair) {
    // pair walks are few (64-2048 lanes) and latency-bound: spread them
    // over every SM before any SM takes a second block
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int per_sm = sms > 0 ? (p.W + sms - 1) / sms : 1;
    if (per_sm * GT < threads) threads = per_sm * GT;
  }
  const size_t smem = smem_bytes(p, threads, GT, pair);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(walk_greedy_kernel<L, H, kDeep, kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = threads / GT;
  walk_greedy_kernel<L, H, kDeep, kMode><<<(p.W + tiles - 1) / tiles, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L, bool kDeep, int kMode>
int launch_hash(const Walk& p, cudaStream_t stream) {
  switch (p.num_hash) {
    case 1:
      return launch<L, 1, kDeep, kMode>(p, stream);
    case 2:
      return launch<L, 2, kDeep, kMode>(p, stream);
    case 3:
      return launch<L, 3, kDeep, kMode>(p, stream);
    default:
      return launch<L, 0, kDeep, kMode>(p, stream);
  }
}

template <int L>
int launch_layout(const Walk& p, int mode, cudaStream_t stream) {
  if (mode == kPairMode) return launch_hash<L, false, kPairMode>(p, stream);
  if (mode == kNaive) return launch_hash<L, false, kNaive>(p, stream);
  return p.lookahead > 3 ? launch_hash<L, true, kGreedy>(p, stream) : launch_hash<L, false, kGreedy>(p, stream);
}

int launch_walk(const Walk& p, int layout, int mode, cudaStream_t s) {
  switch (layout) {
    case kMf8:
      return launch_layout<kMf8>(p, mode, s);
    case kU16:
      return launch_layout<kU16>(p, mode, s);
    case kI32:
      return launch_layout<kI32>(p, mode, s);
    case kI32Blocked:
      return launch_layout<kI32Blocked>(p, mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Walk make_walk(uint8_t* buf, int32_t* pos, int64_t* fh, int64_t* rh, int64_t* hist, int32_t* status,
               int32_t* hops, float* path_min, const float* min_cov, const int32_t* bound, int W, int max_len,
               int cycle_window, const void* cbf, int size_log2, int num_hash, const float* decode,
               unsigned long long kms, int k, int stranded, int left, int lookahead, int superstep_hops,
               int max_supersteps) {
  const int rows_log2 = size_log2 - 7;
  Walk p{buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound,
         W, max_len, cycle_window, cycle_window + kRingPad, cbf, decode,
         size_log2 >= 64 ? ~0ull : (1ull << size_log2) - 1,
         rows_log2 >= 32 ? 0xFFFFFFFFull : (rows_log2 > 0 ? (1ull << rows_log2) - 1 : 0ull),
         num_hash, (uint64_t)kms, k, stranded, left, lookahead, superstep_hops, max_supersteps};
  return p;
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
  const Walk p = make_walk(buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound, W, max_len,
                           cycle_window, cbf, size_log2, num_hash, decode, kms, k, stranded, left, lookahead,
                           superstep_hops, max_supersteps);
  return launch_walk(p, layout, kGreedy, (cudaStream_t)stream);
}

// walk_greedy's arguments, then the pair ring (W, R) of each hash, R, the
// probe depth D (1 <= D < k), the rpkbf and fpkbf lanes (null where the
// class is off), the pair-key filter's size_log2 and num_hash, and the read
// and fragment pair distances (0 where the class is off)
int walk_pair(uint8_t* buf, int32_t* pos, int64_t* fh, int64_t* rh, int64_t* hist,
              int32_t* status, int32_t* hops, float* path_min, const float* min_cov,
              const int32_t* bound, int W, int max_len, int cycle_window, const void* cbf,
              int layout, int size_log2, int num_hash, const float* decode,
              unsigned long long kms, int k, int stranded, int left, int lookahead,
              int superstep_hops, int max_supersteps, int64_t* ring_fh, int64_t* ring_rh, int R, int D,
              const void* rpkbf, const void* fpkbf, int pk_size_log2, int pk_num_hash, int read_dist,
              int frag_dist, void* stream) {
  if (W <= 0) return 0;
  if (num_hash < 1 || cycle_window < 1 || R < 1 || D < 1 || D > k - 1) return (int)cudaErrorInvalidValue;
  if ((read_dist > 0 || frag_dist > 0) && (pk_num_hash < 1 || pk_size_log2 < 0 || pk_size_log2 > 32))
    return (int)cudaErrorInvalidValue;
  Walk p = make_walk(buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound, W, max_len,
                     cycle_window, cbf, size_log2, num_hash, decode, kms, k, stranded, left, lookahead,
                     superstep_hops, max_supersteps);
  p.ring_fh = ring_fh;
  p.ring_rh = ring_rh;
  p.R = R;
  p.D = D;
  p.pk[0] = read_dist > 0 ? (const uint8_t*)rpkbf : nullptr;
  p.pk[1] = frag_dist > 0 ? (const uint8_t*)fpkbf : nullptr;
  p.dist[0] = read_dist > 0 && rpkbf ? read_dist : 0;
  p.dist[1] = frag_dist > 0 && fpkbf ? frag_dist : 0;
  p.pmask = pk_size_log2 >= 32 ? 0xFFFFFFFFull : (1ull << pk_size_log2) - 1;
  p.pnh = pk_num_hash;
  return launch_walk(p, layout, kPairMode, (cudaStream_t)stream);
}

// the timing of a kProfile build: the 2 * kProfSlots counters of g_prof
// (cycles, then counts, by phase: kPf* in pair mode, kNv* in naive mode)
// into `out` (host memory), then zeroed when `reset`
int walk_profile(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[2 * kProfSlots] = {};
    err = cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
  }
  return (int)err;
}

// walk_greedy's arguments, then tip_probe_depth and whether hops check
// back branches (0 or 1)
int walk_naive(uint8_t* buf, int32_t* pos, int64_t* fh, int64_t* rh, int64_t* hist,
               int32_t* status, int32_t* hops, float* path_min, const float* min_cov,
               const int32_t* bound, int W, int max_len, int cycle_window, const void* cbf,
               int layout, int size_log2, int num_hash, const float* decode,
               unsigned long long kms, int k, int stranded, int left, int lookahead,
               int superstep_hops, int max_supersteps, int tip_probe_depth, int back, void* stream) {
  if (W <= 0) return 0;
  if (num_hash < 1 || cycle_window < 1) return (int)cudaErrorInvalidValue;
  Walk p = make_walk(buf, pos, fh, rh, hist, status, hops, path_min, min_cov, bound, W, max_len,
                     cycle_window, cbf, size_log2, num_hash, decode, kms, k, stranded, left, lookahead,
                     superstep_hops, max_supersteps);
  p.T = tip_probe_depth;
  p.back = back;
  for (int c = 0; c < 4; ++c) p.rot_k[c] = rotl(seed_of(c), k);
  return launch_walk(p, layout, kNaive, (cudaStream_t)stream);
}

}  // extern "C"
