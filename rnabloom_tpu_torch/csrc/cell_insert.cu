// Filter-table insert kernels for Hopper (sm_90a), bound with ctypes.
//
// Every op replaces rnabloom_tpu/ops/histmerge.py:187, the Pallas
// _sweep_kernel (launched by _sweep2, wrapped by hist_update), together with
// the scatter semantics of rnabloom_tpu/bloom/filters.py::bloom_add and
// ::counting_increment_cm: a batch of cell indices is applied to a filter
// table, and the table that comes out equals `table.at[idx]...(mode="drop")`
// followed by apply_cell_increments, bit for bit.  Indices >= numel (or
// negative) are dropped; the trash cell (index == size, inside the array) is
// written like any cell.
//
//   set      uint8 lanes: table[i] = 1
//   add      int32 counters: table[i] += 1 per occurrence
//   add_u16  uint16 counters: table[i] = min(table[i] + n_i, 65535)
//   add_mf8  uint8 MiniFloat: table[i] = increment_codes(table[i], n_i,
//            mix_u01(base + i, salt)), applied ONCE per touched cell with the
//            batch total n_i (the stochastic rounding is not additive, so
//            the per-cell total must be known before the code is written)
//   max      int32, uint16 or uint8 (MiniFloat) cells, a value per index:
//            table[i] = max(table[i], every value of i) (unsigned for uint16
//            and uint8), the scatter-max of the conservative update
//            (filters.py::counting_increment, XLA's .at[].max in the JAX
//            package; no Pallas kernel)
//
// What bounds them: random accesses to HBM.  Stage 1 at -mem 1 inserts
// about 1M indices per filter per 4096-read batch (4096 reads x 126 k-mers
// x 2 hashes) into tables far larger than the 50 MB L2 (cbf 2^29 mf8 cells
// = 512 MiB, rpkbf 2^27 lanes = 128 MiB), so nearly every distinct cell is
// one uncached 32-byte sector.  The byte bound (indices plus one sector per
// distinct cell) is about 0.02 ms a batch on the H100's 3.35 TB/s; what the
// card reaches is set by how many random accesses it keeps in flight and by
// atomics that queue on one address.  The TPU kernel sorted the stream and
// swept the table with MXU histograms because TPU scatter costs ~10 ns per
// index; Hopper has fast L2 atomics, so the sort is dropped.
//
// set: store 1 only where the lane reads 0, where that pays.  A plain byte
// store dirties its sector, which the card must merge and write back; a
// store that is not needed leaves the sector clean, so a lane already set
// costs one read and no write-back (on the main path most pair keys recur
// across batches).  On a fresh table the read is a dependent DRAM round
// trip that the plain store does not make.  So each warp probes first: a
// thread takes kSetPerThread indices, each from a warp-wide coalesced
// load, and reads the lane of its first; where at least
// kSetReadFirstPercent of the warp's probed lanes were already 1, the warp
// reads the lanes of the rest together and stores only the 0s, else it
// stores them plainly.  Racing writers store the same byte, so the result
// is deterministic whichever way a warp goes.  On an H100 80GB HBM3 at
// 700 W, a 2^20-index batch whose lanes are all set takes under half the
// time of a plain store a lane, and a fresh batch the same time; reading
// every lane first was a third slower on a fresh batch, and 4 indices a
// thread (a probe for every 4) 5% slower (PERF.md).
//
// add (int32, flat or blocked), one pass.  Integer adds commute, so partial
// totals may be applied in any order and any split.  __match_any_sync
// merges the lanes of a warp that hold one cell, and the lowest of them adds
// their count with one atomicAdd; the result is unused, so it compiles to a
// fire-and-forget RED with no read before it.  On real reads nearly every
// index is its own cell, so this is one RED an index, as an atomic an index
// was; the 10^5-fold cell of a synthetic batch (about 3 lanes a warp)
// queues a third as many REDs on its address.  Totals of a block's whole
// tile first (tile_totals, as add_u16 does) cut that cell to 256 REDs and
// the synthetic batch to 0.083 ms, but cost 13-14% over index_add_ on real
// reads (25% over an atomic an index), where the tile pass merges nothing
// (an H100, PERF.md); the warp merge is no slower than index_add_ on either.
//
// add_u16, one pass.  For increments n >= 0 the saturating add composes:
// min(min(v + a, 65535) + b, 65535) == min(v + a + b, 65535).  So partial
// totals may be applied in any order and any split, and the table comes out
// the same; no global batch total is needed.  A block takes a tile of kTile
// indices and totals them per cell in shared memory (tile_totals): an
// open-addressing table of kSlots = 2 x kTile (uint32 key, int32 count)
// slots, which cannot fill.  Lanes of a warp that hold one key are merged by
// __match_any_sync before they touch it.  Each occupied slot then applies
// its total with one 16-bit atomicCAS, min(old + n, 65535), retried only on
// a lost race and skipped when the cell already holds 65535.  A cell costs
// one global atomic per tile it occurs in (the 10^5-fold cell of a
// 2^20-index batch: 256, not 10^5 serialised on one address).  What bounds
// it (measured on the H100 with variants of this kernel) is the latency of
// one random 2-byte read and then one CAS per distinct cell per tile.  The
// CAS is 16-bit (native since sm_70), not on the aligned 32-bit word: a
// table holds 2^s + 1 cells, and the trash cell's word would reach 2 bytes
// past the tensor.
//
// add_mf8, two passes over an L2-resident batch table.  The MiniFloat
// increment is not additive, so each touched cell needs its whole batch
// total before its one write.  The totals live in a batch table of
// `slots` 8-byte words (a power of two >= 2n, so at most half are ever
// occupied and linear probes stay short): uint32 cell key in the high word
// (kEmpty when free), int32 count in the low word.  For a 2^20-index batch
// that is 2^21 slots, 16 MiB, which stays in L2; the wrapper holds one per
// device, sized from n, never from the table.
//   pass 1 (mf8_tile_kernel): tile_totals as add_u16, then each occupied
//          tile slot adds its total into the batch table: one 64-bit
//          atomicCAS claims a free slot with (key, count) at once, and a
//          slot that already holds the key takes one atomicAdd of the
//          count (no carry reaches the key: a count is < 2^31).  A cell
//          costs one L2 atomic per tile it occurs in.
//   pass 2 (mf8_apply_kernel): one thread per slot, coalesced over the
//          slots; an occupied slot reads its cell, writes
//          increment_code(cell, count, mix_u01(base + cell, salt)) where the
//          code changes (a saturated code, or an increment that draws no
//          bump, leaves the sector clean), and frees the slot.
// Every launch leaves the batch table as it found it, all free, so no
// memset runs between batches.  A key lands in a slot that depends on
// thread order, but each cell still gets exactly one increment of its
// whole total, so the table is deterministic.  What is left is one random
// byte read (and, where the code changes, one write) per distinct cell, as
// for add_u16.
//
// max, a simple first version: one thread per index, grid-stride.  A max
// commutes, so the table comes out the same in any order.  Each thread
// reads its cell from L2 first and writes only where its value is larger:
// on the exact-count build most keys recur across batches with a value
// that their cells already hold, and such a cell costs one read.  int32
// cells then take one atomicMax; uint16 cells a 16-bit atomicCAS loop (as
// add_u16, so the trash cell's word never reaches past the tensor); uint8
// cells an atomicCAS loop on their aligned 32-bit word, which for the last
// cells of a table reaches up to 3 bytes past it: the wrapper takes only
// tables that start their storage, whose block the caching allocator
// rounds to 512 bytes, and a CAS writes the other bytes of the word back
// unchanged.  Fusing the conservative update's gather, min, encode and max
// into one pass is later work.
//
// Keys are uint32, as the JAX package's indices are; 0xFFFFFFFF marks an
// empty slot, so the wrapper refuses add_u16 and add_mf8 tables of 2^32
// cells or more.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond 64 blocks/SM

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// rnabloom_tpu/ops/minifloat.py::mix_u01 (u32 wraparound)
__device__ __forceinline__ float mix_u01(uint32_t idx, uint32_t salt) {
  uint32_t x = idx * 0x9E3779B1u;
  x ^= salt * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x27D4EB2Fu;
  x ^= x >> 15;
  return __int2float_rn((int)(x >> 8)) / 16777216.0f;
}

// floor(log2(f)) for positive float32 f: the exponent bits
__device__ __forceinline__ int floor_log2f(float f) {
  return (__float_as_int(f) >> 23) - 127;
}

// rnabloom_tpu/ops/minifloat.py::increment_codes, one cell
__device__ __forceinline__ uint8_t increment_code(int code, int delta, float u01) {
  int c = code < 127 ? code : 127;
  int d = delta > 0 ? delta : 0;
  int e_old = (c >> 3) - 1;
  e_old = e_old > 0 ? e_old : 0;
  int v = c <= 7 ? c : (((c & 7) | 8) << e_old);
  int n = v + d;
  if (n <= 7) return (uint8_t)n;
  // the float32 conversion (not an integer clz) so that n > 2^24 rounds
  // as the reference rounds it
  int b = floor_log2f(__int2float_rn(n > 8 ? n : 8));
  int e = b - 2;
  int m = n >> (e - 1);
  int v0 = m << (e - 1);
  int raw = (e << 3) | (m & 7);
  bool sat = raw >= 127;
  float q = __int2float_rn(1 << (e - 1 > 0 ? e - 1 : 0));
  bool bump = !sat && (__fmul_rn(u01, q) < __int2float_rn(n - v0));
  int big = raw + (bump ? 1 : 0);
  return (uint8_t)(big < 127 ? big : 127);
}

constexpr int kSetPerThread = 8;
constexpr int kSetReadFirstPercent = 25;
constexpr int kSetBlock = kThreads * kSetPerThread;  // indices per block and pass

__global__ void __launch_bounds__(kThreads)
set_u8_kernel(uint8_t* __restrict__ table, unsigned long long numel,
              const long long* __restrict__ idx, long long n) {
  // base is uniform over the block, so every lane runs every step and the
  // full mask of __ballot_sync is exact
  for (long long base = (long long)blockIdx.x * kSetBlock; base < n;
       base += (long long)gridDim.x * kSetBlock) {
    unsigned long long i[kSetPerThread];
#pragma unroll
    for (int j = 0; j < kSetPerThread; ++j) {
      long long t = base + j * kThreads + threadIdx.x;
      i[j] = t < n ? (unsigned long long)idx[t] : numel;
    }
    // the probe: each lane's first index reads its lane before the store
    bool valid = i[0] < numel;
    uint8_t probe = valid ? __ldcg(table + i[0]) : (uint8_t)1;
    if (probe == 0) table[i[0]] = 1;
    int probed = __popc(__ballot_sync(0xFFFFFFFFu, valid));
    int found = __popc(__ballot_sync(0xFFFFFFFFu, valid && probe != 0));
    if (100 * found >= kSetReadFirstPercent * probed) {
      // enough lanes already set: read first, store only a 0
      uint8_t lane[kSetPerThread];
#pragma unroll
      for (int j = 1; j < kSetPerThread; ++j) lane[j] = i[j] < numel ? __ldcg(table + i[j]) : (uint8_t)1;
#pragma unroll
      for (int j = 1; j < kSetPerThread; ++j) {
        if (lane[j] == 0) table[i[j]] = 1;
      }
    } else {
      // few set, as on a fresh table: plain stores
#pragma unroll
      for (int j = 1; j < kSetPerThread; ++j) {
        if (i[j] < numel) table[i[j]] = 1;
      }
    }
  }
}

// add: the warp's lanes holding one cell add their count with one RED.
// base is uniform over the block, so every lane runs every step and the
// full mask is exact
__global__ void add_i32_kernel(int* __restrict__ table, unsigned long long numel,
                               const long long* __restrict__ idx, long long n) {
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += (long long)gridDim.x * blockDim.x) {
    const long long t = base + threadIdx.x;
    const unsigned long long i = t < n ? (unsigned long long)idx[t] : numel;  // negative: huge, dropped
    const unsigned long long key = i < numel ? i : ~0ull;
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, key);
    if (key != ~0ull && lane == __ffs((int)peers) - 1) atomicAdd(table + key, __popc(peers));
  }
}

// 1024 x 4 was the fastest shape probed on the H100 for add_u16, on random,
// real-read and hot-cell batches alike: the flush's dependent load and CAS
// need many warps in flight, and smaller tiles lose on a cell that recurs
// across tiles, since each tile holding it adds one atomic on its address
constexpr int kTileThreads = 1024;
constexpr int kTilePerThread = 4;
constexpr int kTile = kTileThreads * kTilePerThread;  // indices per block
constexpr int kSlotsLog2 = 13;
constexpr int kSlots = 1 << kSlotsLog2;  // 2 x kTile: the table never fills
constexpr int kTileSmem = kSlots * (int)(sizeof(uint32_t) + sizeof(int));  // 64 KiB, dynamic
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
// a thread flushes its slots together: all loads, then all atomics
constexpr int kSlotsPerThread = kSlots / kTileThreads;
static_assert(kSlots == kTileThreads * kSlotsPerThread, "the flush covers every slot");

// add n to key's slot of the tile table, claiming an empty slot if needed
__device__ __forceinline__ void tile_add(uint32_t* keys, int* counts, uint32_t key, int n) {
  uint32_t s = (key * 0x9E3779B1u) >> (32 - kSlotsLog2);
  while (true) {
    // a slot's key goes from kEmpty to its key once, so a stale read can
    // only be kEmpty, and the CAS then returns the real key
    uint32_t cur = ((volatile uint32_t*)keys)[s];
    if (cur == kEmpty) {
      cur = atomicCAS(keys + s, kEmpty, key);
      if (cur == kEmpty) cur = key;
    }
    if (cur == key) {
      atomicAdd(counts + s, n);
      return;
    }
    s = (s + 1) & (kSlots - 1);
  }
}

// The block's tile of kTile indices totalled per cell into the shared
// table (keys, counts), which it first empties.  Ends with __syncthreads().
__device__ __forceinline__ void tile_totals(uint32_t* keys, int* counts, unsigned long long numel,
                                            const long long* __restrict__ idx, long long n) {
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) {
    keys[s] = kEmpty;
    counts[s] = 0;
  }

  // the tile's indices, coalesced; dropped ones (>= numel, or negative and
  // so huge as unsigned) and the ragged tail become kEmpty
  const long long base = (long long)blockIdx.x * kTile;
  uint32_t key[kTilePerThread];
#pragma unroll
  for (int j = 0; j < kTilePerThread; ++j) {
    long long t = base + j * kTileThreads + threadIdx.x;
    unsigned long long i = t < n ? (unsigned long long)idx[t] : numel;
    key[j] = i < numel ? (uint32_t)i : kEmpty;
  }
  __syncthreads();

  // every lane runs every step, so the full mask is exact
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kTilePerThread; ++j) {
    unsigned int peers = __match_any_sync(0xFFFFFFFFu, key[j]);
    if (key[j] != kEmpty && lane == __ffs((int)peers) - 1) tile_add(keys, counts, key[j], __popc(peers));
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned short sat_u16(unsigned short v, int n) {
  unsigned int s = (unsigned int)v + (unsigned int)n;
  return (unsigned short)(s < 65535u ? s : 65535u);
}

__global__ void __launch_bounds__(kTileThreads)
add_u16_tile_kernel(unsigned short* table, unsigned long long numel,
                    const long long* __restrict__ idx, long long n) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;
  int* counts = (int*)(smem + kSlots);
  tile_totals(keys, counts, numel, idx, n);

  // one saturating CAS per occupied slot; an empty slot reads as a cell at
  // 65535, which needs no write
  uint32_t cell[kSlotsPerThread];
  int add[kSlotsPerThread];
  unsigned short old[kSlotsPerThread], seen[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    int s = j * kTileThreads + threadIdx.x;
    cell[j] = keys[s];
    add[j] = counts[s];
    old[j] = cell[j] != kEmpty ? table[cell[j]] : (unsigned short)65535;
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    seen[j] = old[j] != 65535 ? atomicCAS(table + cell[j], old[j], sat_u16(old[j], add[j])) : old[j];
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    while (seen[j] != old[j]) {  // another tile wrote the cell first
      old[j] = seen[j];
      if (old[j] == 65535) break;
      seen[j] = atomicCAS(table + cell[j], old[j], sat_u16(old[j], add[j]));
    }
  }
}

constexpr unsigned long long kFreeSlot = (unsigned long long)kEmpty << 32;  // key kEmpty, count 0

// A key's first slot in a batch table of mask + 1 slots: murmur3's 32-bit
// finaliser, whose low bits do not follow the tile table's (the top bits of
// a multiplicative hash)
__device__ __forceinline__ uint32_t batch_slot(uint32_t key, uint32_t mask) {
  uint32_t x = key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x & mask;
}

__global__ void __launch_bounds__(kTileThreads)
mf8_tile_kernel(unsigned long long* __restrict__ batch, uint32_t mask, unsigned long long numel,
                const long long* __restrict__ idx, long long n) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;
  int* counts = (int*)(smem + kSlots);
  tile_totals(keys, counts, numel, idx, n);

  // each occupied tile slot adds (key, total) into the batch table; all
  // first probes are issued before any retry
  unsigned long long word[kSlotsPerThread], seen[kSlotsPerThread];
  uint32_t slot[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    int s = j * kTileThreads + threadIdx.x;
    uint32_t key = keys[s];
    word[j] = key != kEmpty ? ((unsigned long long)key << 32) | (uint32_t)counts[s] : kFreeSlot;
    slot[j] = batch_slot(key, mask);
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    seen[j] = word[j] != kFreeSlot ? atomicCAS(batch + slot[j], kFreeSlot, word[j]) : kFreeSlot;
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    // seen == kFreeSlot: this thread claimed the slot with its total
    while (seen[j] != kFreeSlot) {
      if ((seen[j] >> 32) == (word[j] >> 32)) {  // the key's slot: add the count
        atomicAdd(batch + slot[j], word[j] & 0xFFFFFFFFull);
        break;
      }
      slot[j] = (slot[j] + 1) & mask;  // another key's slot: probe on
      seen[j] = atomicCAS(batch + slot[j], kFreeSlot, word[j]);
    }
  }
}

__global__ void mf8_apply_kernel(uint8_t* __restrict__ table, unsigned long long* __restrict__ batch,
                                 long long slots, uint32_t salt, uint32_t base) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < slots;
       s += (long long)gridDim.x * blockDim.x) {
    unsigned long long w = batch[s];
    if (w == kFreeSlot) continue;
    uint32_t cell = (uint32_t)(w >> 32);
    uint8_t old = table[cell];
    uint8_t code = increment_code(old, (int)(uint32_t)w, mix_u01(base + cell, salt));
    if (code != old) table[cell] = code;
    batch[s] = kFreeSlot;
  }
}

// max: read the cell (L2), raise it only where the value is larger
__global__ void max_i32_kernel(int* __restrict__ table, unsigned long long numel, const long long* __restrict__ idx,
                               const int* __restrict__ vals, long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += (long long)gridDim.x * blockDim.x) {
    const unsigned long long i = (unsigned long long)idx[t];  // negative: huge, dropped
    if (i >= numel) continue;
    const int v = vals[t];
    if (__ldcg(table + i) < v) atomicMax(table + i, v);
  }
}

__global__ void max_u16_kernel(unsigned short* __restrict__ table, unsigned long long numel,
                               const long long* __restrict__ idx, const unsigned short* __restrict__ vals,
                               long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += (long long)gridDim.x * blockDim.x) {
    const unsigned long long i = (unsigned long long)idx[t];
    if (i >= numel) continue;
    const unsigned short v = vals[t];
    unsigned short old = __ldcg(table + i);
    while (old < v) {
      const unsigned short seen = atomicCAS(table + i, old, v);
      if (seen == old) break;
      old = seen;
    }
  }
}

__global__ void max_u8_kernel(uint8_t* __restrict__ table, unsigned long long numel,
                              const long long* __restrict__ idx, const uint8_t* __restrict__ vals, long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += (long long)gridDim.x * blockDim.x) {
    const unsigned long long i = (unsigned long long)idx[t];
    if (i >= numel) continue;
    const uint32_t v = vals[t];
    const uintptr_t addr = (uintptr_t)(table + i);
    unsigned int* word = (unsigned int*)(addr & ~(uintptr_t)3);
    const int shift = (int)(addr & 3) * 8;
    unsigned int old = __ldcg(word);
    while (((old >> shift) & 0xFFu) < v) {
      const unsigned int seen = atomicCAS(word, old, (old & ~(0xFFu << shift)) | (v << shift));
      if (seen == old) break;
      old = seen;
    }
  }
}

}  // namespace

extern "C" {

int cell_set_u8(void* table, long long numel, const void* idx, long long n, void* stream) {
  if (n > 0) {
    long long b = (n + kSetBlock - 1) / kSetBlock;
    set_u8_kernel<<<(unsigned int)(b < kMaxBlocks ? b : kMaxBlocks), kThreads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)table, (unsigned long long)numel, (const long long*)idx, n);
  }
  return (int)cudaGetLastError();
}

int cell_add_i32(void* table, long long numel, const void* idx, long long n, void* stream) {
  if (n > 0) {
    add_i32_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (int*)table, (unsigned long long)numel, (const long long*)idx, n);
  }
  return (int)cudaGetLastError();
}

int cell_add_u16(void* table, long long numel, const void* idx, long long n, void* stream) {
  if (n > 0) {
    int err = (int)cudaFuncSetAttribute(add_u16_tile_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err) return err;
    add_u16_tile_kernel<<<(unsigned int)((n + kTile - 1) / kTile), kTileThreads, kTileSmem,
                          (cudaStream_t)stream>>>(
        (unsigned short*)table, (unsigned long long)numel, (const long long*)idx, n);
  }
  return (int)cudaGetLastError();
}

// batch: `slots` free words (a power of two >= 2n, at most 2^32), which the
// launch leaves free.  base: added (mod 2^32) to a cell's index where it
// keys the rounding, so that a shard of a table sharded by index range
// rounds as the whole table would (0 for a whole table)
int cell_add_mf8_batch(void* table, void* batch, long long slots, long long numel, const void* idx,
                       long long n, unsigned int salt, unsigned int base, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int err = (int)cudaFuncSetAttribute(mf8_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kTileSmem);
    if (err) return err;
    mf8_tile_kernel<<<(unsigned int)((n + kTile - 1) / kTile), kTileThreads, kTileSmem, s>>>(
        (unsigned long long*)batch, (uint32_t)(slots - 1), (unsigned long long)numel,
        (const long long*)idx, n);
    err = (int)cudaGetLastError();
    if (err) return err;
    mf8_apply_kernel<<<blocks_for(slots), kThreads, 0, s>>>(
        (uint8_t*)table, (unsigned long long*)batch, slots, (uint32_t)salt, (uint32_t)base);
  }
  return (int)cudaGetLastError();
}

// max: table[idx[t]] = max(table[idx[t]], vals[t]); vals has the table's
// element type
int cell_max_i32(void* table, long long numel, const void* idx, const void* vals, long long n, void* stream) {
  if (n > 0) {
    max_i32_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (int*)table, (unsigned long long)numel, (const long long*)idx, (const int*)vals, n);
  }
  return (int)cudaGetLastError();
}

int cell_max_u16(void* table, long long numel, const void* idx, const void* vals, long long n, void* stream) {
  if (n > 0) {
    max_u16_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (unsigned short*)table, (unsigned long long)numel, (const long long*)idx, (const unsigned short*)vals, n);
  }
  return (int)cudaGetLastError();
}

int cell_max_u8(void* table, long long numel, const void* idx, const void* vals, long long n, void* stream) {
  if (n > 0) {
    max_u8_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)table, (unsigned long long)numel, (const long long*)idx, (const uint8_t*)vals, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
