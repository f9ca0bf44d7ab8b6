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
// The narrow counters (u16, mf8) cannot be updated by one atomic per
// occurrence: the saturating add and the MiniFloat increment must see the
// batch total.  So they run in two passes over the index list:
//   pass 1: atomicAdd(&scratch[i], 1)           -> per-cell batch totals
//   pass 2: n = atomicExch(&scratch[i], 0)      -> exactly one thread per
//           distinct cell sees n > 0 and writes the new code
// Pass 2 also leaves the scratch zeroed for the next batch, so the wrapper
// allocates it once per table size, not per batch.  The scratch is int32,
// as long as the table: 2 GiB for the 2^29-cell cbf at -mem 1, and 4 GiB
// when the FPR check doubles the cbf to 2^30 cells.  The result does not
// depend on thread order, so it is deterministic.
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

// pass 1 of the narrow ops: per-cell batch totals
__global__ void tally_kernel(int* __restrict__ scratch, unsigned long long numel,
                             const long long* __restrict__ idx, long long n) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i < numel) atomicAdd(scratch + i, 1);
  }
}

__global__ void apply_u16_kernel(uint16_t* __restrict__ table, int* __restrict__ scratch,
                                 unsigned long long numel, const long long* __restrict__ idx,
                                 long long n) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long i = (unsigned long long)idx[t];
    if (i >= numel) continue;
    int cnt = atomicExch(scratch + i, 0);
    if (cnt > 0) {
      int v = (int)table[i] + cnt;
      table[i] = (uint16_t)(v < 65535 ? v : 65535);
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

int cell_add_u16(void* table, void* scratch, long long numel, const void* idx, long long n,
                 void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    tally_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (int*)scratch, (unsigned long long)numel, (const long long*)idx, n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    apply_u16_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (uint16_t*)table, (int*)scratch, (unsigned long long)numel, (const long long*)idx, n);
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
