// Filter-table insert kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces rnabloom_tpu/ops/histmerge.py::_sweep_kernel (launched by
// _sweep2, wrapped by hist_update) together with the scatter semantics of
// rnabloom_tpu/bloom/filters.py::bloom_add and ::counting_increment_cm:
// a batch of cell indices is applied to a filter table, and the table that
// comes out equals `table.at[idx]...(mode="drop")` followed by
// apply_cell_increments, bit for bit.  Indices >= numel are dropped; the
// trash cell (index == size, inside the array) is written like any cell.
//
//   set      uint8 lanes: table[i] = 1
//   add      int32 counters: table[i] += 1 per occurrence
//   add_u16  uint16 counters: table[i] = min(table[i] + n_i, 65535)
//   add_mf8  uint8 MiniFloat: table[i] = increment_codes(table[i], n_i,
//            mix_u01(i, salt)), applied ONCE per touched cell with the
//            batch total n_i (the stochastic rounding is not additive, so
//            the per-cell total must be known before the code is written)
//
// What bounds it: random traffic to HBM.  Stage 1 at -mem 1 inserts about
// 1M indices per filter per 4096-read batch (4096 reads x 126 k-mers x 2
// hashes) into tables far larger than the 50 MB L2 (cbf 2^29 mf8 cells =
// 512 MiB, rpkbf 2^27 lanes = 128 MiB), so nearly every index is one
// uncached 32-byte sector read-modify-write.  The TPU kernel sorted the
// stream and swept the table with MXU histograms because TPU scatter costs
// ~10 ns per index; Hopper has fast global atomics, so the sort is dropped
// and each index is one atomic (or one plain store) at its cell.
//
// The two narrow counters need different schedules.
//
// add_u16, one pass.  For increments n >= 0 the saturating add composes:
// min(min(v + a, 65535) + b, 65535) == min(v + a + b, 65535).  So partial
// totals may be applied in any order and any split, and the table comes out
// the same; no global batch total is needed.  A block takes a tile of kTile
// indices and totals them per cell in shared memory: an open-addressing
// table of kSlots = 2 x kTile (uint32 key, int32 count) slots, which cannot
// fill.  Lanes of a warp that hold one key are merged by __match_any_sync
// before they touch it.  Each occupied slot then applies its total with one
// 16-bit atomicCAS, min(old + n, 65535), retried only on a lost race and
// skipped when the cell already holds 65535.  A cell costs one global atomic
// per tile it occurs in (the 10^5-fold cell of a 2^20-index batch: 256, not
// 10^5 serialised on one address), and there is no scratch.  What bounds it
// (measured on the H100 with variants of this kernel) is the latency of one
// random 2-byte read and then one CAS per distinct cell per tile, on a table
// far larger than L2 (the tile totals take about a fifth of the time), and
// the chain of CAS on a cell that recurs across tiles.  Keys are uint32, as
// the JAX package's indices are; 0xFFFFFFFF marks an empty slot, so the
// wrapper refuses tables of 2^32 cells or more.  The CAS is 16-bit (native since sm_70), not on the
// aligned 32-bit word: a table holds 2^s + 1 cells, and the trash cell's
// word would reach 2 bytes past the tensor.
//
// add_mf8, two passes.  The MiniFloat increment is stochastic and not
// additive (two increments of a and b do not give the increment of a + b),
// so each touched cell's code must be written once, from its batch total:
//   pass 1: atomicAdd(&scratch[i], 1)           -> per-cell batch totals
//   pass 2: n = atomicExch(&scratch[i], 0)      -> exactly one thread per
//           distinct cell sees n > 0 and writes the new code
// The int32 scratch is mf8's alone.  It is as long as the table: 2 GiB for
// the 2^29-cell cbf at -mem 1, and 4 GiB when the FPR check doubles the cbf
// to 2^30 cells.  Pass 2 leaves it zeroed for the next batch, so the wrapper
// allocates it once per table size.  What bounds mf8 is two random int32
// atomics per index on the scratch and one byte read-modify-write per
// distinct cell; a cell repeated in a batch serialises its atomics on one
// address in both passes.
//
// Neither result depends on thread order, so both are deterministic.
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

__global__ void set_u8_kernel(uint8_t* __restrict__ table, unsigned long long numel,
                              const long long* __restrict__ idx, long long n) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i < numel) table[i] = 1;  // racing writers store the same byte
  }
}

__global__ void add_i32_kernel(int* __restrict__ table, unsigned long long numel,
                               const long long* __restrict__ idx, long long n) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i < numel) atomicAdd(table + i, 1);
  }
}

// pass 1 of add_mf8: per-cell batch totals
__global__ void tally_kernel(int* __restrict__ scratch, unsigned long long numel,
                             const long long* __restrict__ idx, long long n) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i < numel) atomicAdd(scratch + i, 1);
  }
}

// 1024 x 4 was the fastest shape probed on the H100, on random, real-read
// and hot-cell batches alike: the flush's dependent load and CAS need many
// warps in flight, and smaller tiles lose on a cell that recurs across
// tiles, since each tile holding it adds one CAS to a chain on its address
constexpr int kTileThreads = 1024;
constexpr int kTilePerThread = 4;
constexpr int kTile = kTileThreads * kTilePerThread;  // indices per block
constexpr int kSlotsLog2 = 13;
constexpr int kSlots = 1 << kSlotsLog2;  // 2 x kTile: the table never fills
constexpr int kTileSmem = kSlots * (int)(sizeof(uint32_t) + sizeof(int));  // 64 KiB, dynamic
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
// a thread flushes its slots together: all loads, then all CAS
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

__global__ void apply_mf8_kernel(uint8_t* __restrict__ table, int* __restrict__ scratch,
                                 unsigned long long numel, const long long* __restrict__ idx,
                                 long long n, uint32_t salt) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i >= numel) continue;
    int cnt = atomicExch(scratch + i, 0);
    if (cnt > 0) table[i] = increment_code(table[i], cnt, mix_u01((uint32_t)i, salt));
  }
}

}  // namespace

extern "C" {

int cell_set_u8(void* table, long long numel, const void* idx, long long n, void* stream) {
  if (n > 0) {
    set_u8_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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

int cell_add_mf8(void* table, void* scratch, long long numel, const void* idx, long long n,
                 unsigned int salt, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    tally_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (int*)scratch, (unsigned long long)numel, (const long long*)idx, n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    apply_mf8_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (uint8_t*)table, (int*)scratch, (unsigned long long)numel, (const long long*)idx, n,
        (uint32_t)salt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
