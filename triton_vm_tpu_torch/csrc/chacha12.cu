// ChaCha12 (rand::StdRng) draws of Goldilocks elements on Hopper (sm_90a):
// the prover's randomizers, every row of one call in one launch.
//
// `chacha12_bfe_kernel` replaces no TPU kernel: the JAX package draws its
// randomizers on the host (triton_vm_tpu/utils/stdrng.py::drbg_bfes_batch,
// a numpy keystream whose Canon step runs on Python ints). It was added
// because that host loop left the card idle for the longest stretch of a
// prove: about 3.3 M draws at padded height 2^20, microseconds each on one
// host thread.
//
// What bounds it on this card: integer instruction issue, not bytes. A
// ChaCha12 block is 6 double rounds of 8 quarter rounds, each 4 adds, 4
// xors and 4 rotates, plus 16 adds of the input state: 592 32-bit
// operations for 64 bytes of keystream, which Canon's method turns into 4
// field elements, 32 bytes written. HBM would carry those 32 bytes in a
// hundredth of the time the integer lanes need for the 592 operations. So
// one thread owns one block, its 16 words in registers, the rounds fully
// unrolled, each rotate one funnel shift; a launch of a 2^20 prove's batch
// randomizer is 786,432 threads, enough to fill every SM.
//
// Output layout, written straight from registers: draw j of row b goes to
// out[b n + (j % C) (n / C) + j / C]. C = 1 gives the main table's (B, n)
// rows; C = 3 gives XFE rows stored component-major, (B, 3, n / 3), as the
// prover commits the aux table, stores the batch-randomizer column and
// feeds the quotient randomizer. The grid is (blocks of a row, rows), so a
// thread finds its row and block counter without a division.
//
// Canon's method (rand's `random_range(0..=P-1)`, as in
// triton_vm_tpu_torch/utils/stdrng.py::ChaCha12Rng.random_range_u64_inclusive):
// v = next_u64(), (hi, lo) = v * P; when lo > 2^64 - P (= 2^32 - 1), a
// second word v2 adds the carry of lo + hi(v2 * P). A draw therefore reads
// u64 words 2k and 2k + 1 of its row's stream, low 32-bit word first, so
// block c holds draws 4c .. 4c + 3. A draw with lo <= 2^32 - 1
// (probability 2^-32) reads one word only and shifts every later draw of
// its row: the kernel then sets flags[b], and the wrapper
// (ops/stdrng_cuda.py) redraws that row exactly on the host.
//
// Interface: plain C, driven through ctypes (ops/stdrng_cuda.py). The
// launcher enqueues on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kBiasZone = 0xFFFFFFFFull;  // 2^64 - P
constexpr int kThreads = 128;
constexpr int kDoubleRounds = 6;  // ChaCha12
constexpr int kDrawsPerBlock = 4;  // 16 words = 8 u64 = 4 draws of 2

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
chacha12_bfe_kernel(const uint32_t* __restrict__ keys, uint32_t n,
                    uint32_t blocks_per_row, uint64_t* __restrict__ out,
                    int64_t* __restrict__ flags) {
  const uint32_t counter = blockIdx.x * kThreads + threadIdx.x;
  if (counter >= blocks_per_row) return;
  const uint32_t row = blockIdx.y;
  const uint32_t* key = keys + 8 * static_cast<uint64_t>(row);
  // "expand 32-byte k", the key, the 64-bit block counter (its high word
  // 0: a row has fewer than 2^30 blocks), the 64-bit stream id 0
  const uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                          key[0], key[1], key[2], key[3],
                          key[4], key[5], key[6], key[7],
                          counter, 0u, 0u, 0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = s[i];
#pragma unroll
  for (int r = 0; r < kDoubleRounds; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += s[i];

  uint64_t* row_out = out + static_cast<uint64_t>(row) * n;
  const uint32_t per_component = n / C;
  bool skipped = false;
#pragma unroll
  for (int q = 0; q < kDrawsPerBlock; ++q) {
    const uint32_t j = counter * kDrawsPerBlock + q;
    if (j < n) {
      const uint64_t v = x[4 * q] | (static_cast<uint64_t>(x[4 * q + 1]) << 32);
      const uint64_t v2 =
          x[4 * q + 2] | (static_cast<uint64_t>(x[4 * q + 3]) << 32);
      const uint64_t lo = v * kP;
      const uint64_t hi = __umul64hi(v, kP);
      const bool biased = lo > kBiasZone;
      const uint64_t hi2 = __umul64hi(v2, kP);
      skipped |= !biased;
      row_out[(j % C) * per_component + j / C] =
          hi + static_cast<uint64_t>(biased && lo + hi2 < lo);
    }
  }
  if (skipped) flags[row] = 1;
}

}  // namespace

extern "C" {

// keys: (rows, 8) u32 row keys; n draws a row (n < 2^32, a multiple of
// components); out: rows * n u64 in the layout above; flags: rows int64,
// zeroed by the caller, set to 1 for a row with a draw outside the bias
// branch.
int chacha12_bfe_launch(const void* keys, int64_t rows, int64_t n,
                        int components, void* out, void* flags,
                        void* stream) {
  const uint32_t blocks_per_row =
      static_cast<uint32_t>((n + kDrawsPerBlock - 1) / kDrawsPerBlock);
  const dim3 grid((blocks_per_row + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* o = static_cast<uint64_t*>(out);
  auto* f = static_cast<int64_t*>(flags);
  if (components == 3) {
    chacha12_bfe_kernel<3><<<grid, kThreads, 0, st>>>(
        k, static_cast<uint32_t>(n), blocks_per_row, o, f);
  } else if (components == 1) {
    chacha12_bfe_kernel<1><<<grid, kThreads, 0, st>>>(
        k, static_cast<uint32_t>(n), blocks_per_row, o, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* chacha12_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
