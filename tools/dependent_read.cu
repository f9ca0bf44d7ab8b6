// The card's latency of dependent random reads: one block of `threads`
// threads, each following `chains` chains of reads of a byte table, where
// every read's address depends on the byte its chain read before; the
// chains of a thread issue their reads of a step together, so a step is
// one round of threads * chains random reads from one SM.
// chip_smoke.py phase 6 and tools/pair_profile.py build it (nvcc, sm_90a,
// bound with ctypes) and time it over the walk kernel's counter table,
// beside the pair kernel's time per dependent round.
//
//   int dependent_read(const uint8_t* table, unsigned long long mask, int steps,
//                      unsigned long long seed, unsigned long long* out,
//                      int threads, int chains, void* stream)
//
// reads `steps` cells of each chain among the first mask + 1 (the index is
// the low bits of a hash of the chain's state and the byte it read), adds
// the last states into out[0] so that no read is dead, launches on
// `stream` and returns cudaGetLastError().  chains: 1, 2, 4 or 10.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int C>
__global__ void dependent_read_kernel(const uint8_t* table, uint64_t mask, int steps, uint64_t seed,
                                      unsigned long long* out) {
  uint64_t x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = seed + 0x9E3779B97F4A7C15ull * (threadIdx.x * C + c + 1);
  for (int i = 0; i < steps; ++i) {
    uint8_t b[C];
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = table[x[c] & mask];
#pragma unroll
    for (int c = 0; c < C; ++c) {  // a splitmix64 step of the state plus the byte read
      x[c] += 0x9E3779B97F4A7C15ull + b[c];
      x[c] = (x[c] ^ (x[c] >> 30)) * 0xBF58476D1CE4E5B9ull;
      x[c] = (x[c] ^ (x[c] >> 27)) * 0x94D049BB133111EBull;
      x[c] ^= x[c] >> 31;
    }
  }
  uint64_t sum = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) sum += x[c];
  atomicAdd(out, (unsigned long long)sum);
}

}  // namespace

extern "C" int dependent_read(const uint8_t* table, unsigned long long mask, int steps, unsigned long long seed,
                              unsigned long long* out, int threads, int chains, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1:
      dependent_read_kernel<1><<<1, threads, 0, s>>>(table, mask, steps, seed, out);
      break;
    case 2:
      dependent_read_kernel<2><<<1, threads, 0, s>>>(table, mask, steps, seed, out);
      break;
    case 4:
      dependent_read_kernel<4><<<1, threads, 0, s>>>(table, mask, steps, seed, out);
      break;
    case 10:
      dependent_read_kernel<10><<<1, threads, 0, s>>>(table, mask, steps, seed, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
