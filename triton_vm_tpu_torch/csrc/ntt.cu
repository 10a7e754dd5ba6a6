// The batched Goldilocks NTT on Hopper (sm_90a): K4, every transform of
// ops/ntt.py on a tensor on the card. A row of the batch maps natural-order
// input x (n_in words, zero-padded to n, optionally scaled word by word) to
// natural-order output out_k = post_k * sum_i x_i w^(i k), w a primitive
// n-th root of unity, n = 2^log_n up to 2^24.
//
// K4 replaces no Pallas kernel: the JAX package computes the transform with
// XLA, triton_vm_tpu/ops/ntt.py::ntt_dif / ntt_dit (:70-121), a
// constant-geometry radix-2 network under a fori_loop, jitted at :124-204.
//
// What bounds it on this card: integer multiplies. A transform of length n
// runs n/2 log2 n Goldilocks products (8 int32 multiplies each) against
// 16 bytes a word of traffic, so from n = 2^5 up the products, not the
// bytes, are the bound. What this first design does about it is to read and
// write device memory once per pass, one or two passes a transform,
// instead of once per radix-2 stage:
//
// - A pass (ops/ntt_cuda.py::plan) runs independent transforms of length
//   L <= 2^12 over sub-sequences of each row: element j of sub-sequence s
//   lies at in-row position s * in_seq + j * in_elem on the load and
//   s * out_seq + j * out_elem on the store. A CTA takes `tile`
//   sub-sequences (a power of two), holds them in shared memory, and runs
//   all log2 L stages there.
// - n <= 2^12: one pass, the rows themselves the sub-sequences.
// - n = n1 n2 > 2^12 (four-step, Bailey): pass 1 transforms the n1
//   strided columns i1 (positions i1 + n1 i2, length n2, root w^n1) and
//   writes each as a contiguous run (position n2 i1 + k2), the transpose
//   folded into the addressing; pass 2 multiplies element i1 of column k2
//   by w^(i1 k2) on its load, transforms the columns k2 (positions
//   k2 + n2 i1, length n1, root w^n2) and writes X[k2 + n2 k1] to the same
//   positions, in place. Each word is read and written twice.
// - The coset scale and the zero-padding happen on the first pass's load
//   (input position p: x_p * pre_p, 0 from p >= n_in), the iNTT's
//   offset^-k / n on the last pass's store (output position k).
// - In shared memory a sub-sequence is stored bit-reversed on the load, then
//   the textbook decimation-in-time stages leave it in natural order. The
//   word at slot i of tile row t lives at t L + (i ^ (((i >> s) ^ t) & 31)),
//   an XOR swizzle that keeps the bit-reversed and the strided accesses of a
//   warp on distinct banks.
// - Loads and stores of a strided pass put a warp's threads on adjacent
//   sub-sequences (adjacent words), of a contiguous pass on adjacent
//   elements. Offsets are 64-bit.
// - Every value the kernel stores is a canonical field element.
//
// Interface: plain C, driven through ctypes (ops/ntt_cuda.py). The launcher
// enqueues one pass on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 512;
// ops/ntt_cuda.py mirrors these as MAX_PASS_LOG, TILE_WORDS_MAX and TW_BITS
constexpr int kMaxLogLen = 12;
constexpr int kMaxLogTileWords = 14;
constexpr int kMaxTileWords = 1 << kMaxLogTileWords;  // 128 KiB of smem
constexpr int kTwBits = 12;             // w^e = lo[e mod 2^12] hi[e >> 12]

struct Pass {
  const uint64_t* in;     // element at in-row position p of row r:
  int64_t in_row;         //   in[r * in_row + p]
  int64_t n_in;           // positions >= n_in read as 0
  uint64_t* out;
  int64_t out_row;
  int64_t rows;
  int log_seqs;           // 2^log_seqs sub-sequences a row
  int64_t in_seq, in_elem, out_seq, out_elem;
  const uint64_t* pre;    // x_p * pre[p] on the load, or null
  const uint64_t* post;   // out_p * post[p] on the store, or null
  const uint64_t* tw_lo;  // element j of sub-sequence s times w^(j s) on
  const uint64_t* tw_hi;  //   the load, or null
  const uint64_t* inner;  // w_L^j for j < L / 2, w_L the pass's root
  int log_len;            // L = 2^log_len
  int log_tile;           // 2^log_tile sub-sequences a CTA
};

// The swizzled shared-memory slot of word i of tile row t.
__device__ __forceinline__ int slot(int t, int i, int log_len) {
  const int s = log_len > 10 ? log_len - 5 : 5;
  const int mask = ((1 << log_len) - 1) & 31;
  return (t << log_len) + (i ^ (((i >> s) ^ t) & mask));
}

__device__ __forceinline__ int bitrev(int j, int log_len) {
  return log_len ? static_cast<int>(__brev(static_cast<unsigned>(j)) >>
                                    (32 - log_len))
                 : 0;
}

// K4: one pass over 2^log_tile sub-sequences a CTA.
__global__ void __launch_bounds__(kThreads) ntt_pass_kernel(const Pass a) {
  extern __shared__ uint64_t sm[];
  const int L = 1 << a.log_len;
  const int words = L << a.log_tile;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) << a.log_tile;
  const int64_t total = a.rows << a.log_seqs;
  const int64_t seq_mask = (int64_t(1) << a.log_seqs) - 1;
  const bool strided_in = a.in_elem != 1;
  const bool strided_out = a.out_elem != 1;

  for (int e = threadIdx.x; e < words; e += kThreads) {
    // adjacent threads on adjacent words of device memory
    const int t = strided_in ? e & ((1 << a.log_tile) - 1) : e >> a.log_len;
    const int j = strided_in ? e >> a.log_tile : e & (L - 1);
    const int64_t g = g0 + t;
    uint64_t v = 0;
    if (g < total) {
      const int64_t r = g >> a.log_seqs, s = g & seq_mask;
      const int64_t p = s * a.in_seq + j * a.in_elem;
      if (p < a.n_in) {
        v = a.in[r * a.in_row + p];
        if (a.pre) v = fmul(v, __ldg(a.pre + p));
        if (a.tw_lo) {
          const int64_t x = s * j;  // < n <= 2^24
          v = fmul(v, fmul(__ldg(a.tw_lo + (x & ((1 << kTwBits) - 1))),
                           __ldg(a.tw_hi + (x >> kTwBits))));
        }
      }
    }
    sm[slot(t, bitrev(j, a.log_len), a.log_len)] = v;
  }
  __syncthreads();

  // decimation in time: bit-reversed in, natural order out
  const int half_log = a.log_len - 1;
  for (int lm = 0; lm < a.log_len; ++lm) {
    const int m = 1 << lm;
    for (int b = threadIdx.x; b < words >> 1; b += kThreads) {
      const int t = b >> half_log;
      const int bb = b & ((1 << half_log) - 1);
      const int jj = bb & (m - 1);
      const int i0 = ((bb >> lm) << (lm + 1)) + jj;
      const int s0 = slot(t, i0, a.log_len), s1 = slot(t, i0 + m, a.log_len);
      const uint64_t u = sm[s0];
      uint64_t w = sm[s1];
      if (lm) w = fmul(w, __ldg(a.inner + (jj << (half_log - lm))));
      sm[s0] = fadd(u, w);
      sm[s1] = fsub(u, w);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int t = strided_out ? e & ((1 << a.log_tile) - 1) : e >> a.log_len;
    const int j = strided_out ? e >> a.log_tile : e & (L - 1);
    const int64_t g = g0 + t;
    if (g >= total) continue;
    const int64_t r = g >> a.log_seqs, s = g & seq_mask;
    const int64_t p = s * a.out_seq + j * a.out_elem;
    uint64_t v = sm[slot(t, j, a.log_len)];
    if (a.post) v = fmul(v, __ldg(a.post + p));
    a.out[r * a.out_row + p] = v;
  }
}

}  // namespace

extern "C" {

// Enqueue one pass of K4 on `stream` (see Pass for the arguments).
int ntt_pass_launch(const void* in, int64_t in_row, int64_t n_in, void* out,
                    int64_t out_row, int64_t rows, int log_seqs,
                    int64_t in_seq, int64_t in_elem, int64_t out_seq,
                    int64_t out_elem, const void* pre, const void* post,
                    const void* tw_lo, const void* tw_hi, const void* inner,
                    int log_len, int log_tile, void* stream) {
  const int64_t blocks = ((rows << log_seqs) + (int64_t(1) << log_tile) - 1)
                         >> log_tile;
  if (log_len < 0 || log_len > kMaxLogLen || log_tile < 0 ||
      log_len + log_tile > kMaxLogTileWords || rows < 1 || log_seqs < 0 ||
      log_seqs > 24 || blocks > 0x7FFFFFFF ||
      (tw_lo != nullptr) != (tw_hi != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pass a{static_cast<const uint64_t*>(in), in_row, n_in,
         static_cast<uint64_t*>(out), out_row, rows, log_seqs,
         in_seq, in_elem, out_seq, out_elem,
         static_cast<const uint64_t*>(pre),
         static_cast<const uint64_t*>(post),
         static_cast<const uint64_t*>(tw_lo),
         static_cast<const uint64_t*>(tw_hi),
         static_cast<const uint64_t*>(inner), log_len, log_tile};
  const int smem = static_cast<int>(sizeof(uint64_t)) << log_len << log_tile;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxTileWords * static_cast<int>(sizeof(uint64_t)));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_pass_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ntt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
