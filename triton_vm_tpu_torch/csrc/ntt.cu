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
// 16 bytes a word of traffic, so from n = 2^13 up the products, not the
// bytes, are the bound. Above 2^12 words a row the four-step split below
// moves each word through device memory twice, so its traffic (the input
// once, then three sweeps of n words) is itself a floor at about two thirds
// of the bound. What the design does about it:
//
// - A pass (ops/ntt_cuda.py::plan) runs independent transforms of length
//   L <= 2^12 over sub-sequences of each row: element j of sub-sequence s
//   lies at in-row position s * in_seq + j * in_elem on the load and
//   s * out_seq + j * out_elem on the store. A CTA takes 2^log_tile
//   sub-sequences, 16 words a thread.
// - n <= 2^12: one pass, the rows themselves the sub-sequences.
// - n = n1 n2 > 2^12 (four-step, Bailey): pass 1 transforms the n1
//   strided columns i1 (positions i1 + n1 i2, length n2, root w^n1) and
//   writes each as a contiguous run (position n2 i1 + k2), the transpose
//   folded into the addressing; pass 2 multiplies element i1 of column k2
//   by w^(i1 k2) on its load, transforms the columns k2 (positions
//   k2 + n2 i1, length n1, root w^n2) and writes X[k2 + n2 k1] to the same
//   positions, in place.
// - Butterflies in registers. A length-L transform runs as up to three
//   levels of radix R = 2^r <= 16 (`levels`, e.g. 16 x 16 x 16 at 2^12):
//   L = R M', and X[k_b + R k_a] = sum_{i_a} w_{M'}^(i_a k_a) (w_L^(i_a k_b)
//   sum_{i_b} x[i_a + M' i_b] w_R^(i_b k_b)). Each thread holds the R words
//   x[i_a + M' i_b] of one group in registers, runs the log2 R radix-2
//   stages there (the roots w_16^j kernel parameters), multiplies by the
//   level's twiddles and writes them back to the positions it read; the
//   next level works on the contiguous segments of M' words. The first
//   level loads from device memory and the last stores to it directly, so
//   shared memory carries only the exchanges between levels: two barriers
//   for a pass of 2^12 (three with the twiddle table's), not twelve.
// - The levels' twiddles w_M^(i_a k_b) are staged once a CTA into shared
//   memory from a table laid out k_b-major (`tables`), so a warp reads
//   consecutive words; no butterfly reads device memory.
// - Lazy reduction: inside a pass a word stands for its value mod p
//   anywhere in [0, 2^64) (csrc/goldilocks.cuh: add_lazy, fsub, fmul); it
//   is made canonical before a butterfly's untwiddled operand is added and
//   on the store, so every stored word is canonical.
// - The coset scale and the zero-padding happen on the first pass's load
//   (input position p: x_p f b^p, 0 from p >= n_in), the iNTT's
//   offset^-k / n on the last pass's store, and pass 2's twiddle w^(s j):
//   each power from two 2^12-word tables, b^e = lo[e mod 2^12] hi[e >> 12]
//   (table_power), not from an n-word table.
// - Shared memory is indexed with 32-bit words through an XOR swizzle that
//   keeps the strided accesses of a half-warp on distinct banks; tiles of
//   32-64 KiB let two or three CTAs share an SM.
//
// Interface: plain C, driven through ctypes (ops/ntt_cuda.py). The launcher
// enqueues one pass on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "goldilocks.cuh"

namespace {

// ops/ntt_cuda.py mirrors these as MAX_PASS_LOG, WORDS_PER_THREAD,
// MAX_THREADS and MAX_INNER_WORDS
constexpr int kMaxLogLen = 12;
constexpr int kE = 16;                   // words a thread holds
constexpr int kMaxThreads = 512;
constexpr int kMaxInnerWords = 4096 + 256;  // the levels' twiddles at 2^12

struct Pass {
  const uint64_t* in;     // element at in-row position p of row r:
  int64_t in_row;         //   in[r * in_row + p]
  int64_t n_in;           // positions >= n_in read as 0
  uint64_t* out;
  int64_t out_row;
  int64_t rows;
  int64_t in_seq, in_elem, out_seq, out_elem;
  const uint64_t* pre_lo;   // x_p * pre_lo[p mod 2^12] * pre_hi[p >> 12]
  const uint64_t* pre_hi;   //   on the load, or null
  const uint64_t* post_lo;  // the same on the store's output position
  const uint64_t* post_hi;
  uint64_t pre_step;        // the scales' ratio from a thread's word to its
  uint64_t post_step;       //   next: base^(in_elem L / 16) on the load,
                            //   base^(out_elem L / R_last) on the store
  const uint64_t* tw_lo;    // element j of sub-sequence s times w^(j s) on
  const uint64_t* tw_hi;    //   the load, or null
  const uint64_t* inner;    // the levels' twiddles, inner_words of them
  int inner_words;
  int log_seqs;             // 2^log_seqs sub-sequences a row
  int log_len;              // L = 2^log_len
  int log_tile;             // 2^log_tile sub-sequences a CTA
  int lv[3];                // radix bits of each level, 0 past the last
  uint64_t rw[8];           // w_16^j: the radix-2 stages' roots
};

// The swizzled shared-memory slot of tile word w.
__device__ __forceinline__ uint32_t swz(uint32_t w) {
  return w ^ (((w >> 4) ^ (w >> 8) ^ (w >> 12)) & 15u);
}

__host__ __device__ constexpr int bitrev(int j, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((j >> b) & 1) << (bits - 1 - b);
  return r;
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1: every index a
// compile-time constant, so that the words a thread holds stay registers.
template <class F, int... I>
__device__ __forceinline__ void static_for_(F&& f,
                                            std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// A length-2^LR DFT in registers: v holds x in bit-reversed order and is
// left holding X in natural order; the radix-2 stage of half-width h uses
// w_(2h)^j = w_16^(8 j / h).
template <int LR>
__device__ __forceinline__ void dft(uint64_t* v, const uint64_t* rw) {
  constexpr int R = 1 << LR;
  static_for<LR>([&](auto stage) {
    constexpr int h = 1 << decltype(stage)::value;
    static_for<R / 2>([&](auto bf) {
      constexpr int i = decltype(bf)::value;
      constexpr int j = i % h, top = (i / h) * 2 * h + j;
      const uint64_t u = v[top];
      const uint64_t w = j ? fmul(v[top + h], rw[j * (8 / h)])
                           : canonical(v[top + h]);
      v[top] = add_lazy(u, w);
      v[top + h] = fsub(u, w);
    });
  });
}

// One level of radix 2^LR over the CTA's tile: segments of M = 2^log_m
// words (M = L on the first level), groups (t, seg, i_a), i_a < M / R, each
// thread 16 / R of them. The first level loads from device memory, the last
// stores to it; the others read and write shared memory in place. `lv0`,
// `lv1` are the first two levels' radix bits (the last level's digit
// reversal), `tw_off` the level's twiddles in `tws`. A thread's scales and
// pass-2 twiddles step by a constant ratio from one of its words to the
// next, so each costs one product (`pre_step`, `post_step`, w^(s Q)).
template <int LR, bool kFirst, bool kLast>
__device__ __forceinline__ void level(const Pass& a, uint64_t* sm,
                                      const uint64_t* tws, int log_m,
                                      int tw_off, int lv0, int lv1) {
  constexpr int R = 1 << LR;
  constexpr int G = kE / R;
  const int l = a.log_len;
  const int log_q = log_m - LR;  // log2(M / R)
  const int64_t total = a.rows << a.log_seqs;
  const int64_t seq_mask = (int64_t(1) << a.log_seqs) - 1;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) << a.log_tile;
  const uint32_t tmask = (1u << a.log_tile) - 1;
#pragma unroll 1
  for (int u = 0; u < G; ++u) {
    const uint32_t g = threadIdx.x + blockDim.x * u;
    uint64_t v[R];
    uint32_t t, ia = 0, base = 0, xb = 0;
    if (kFirst) {
      // adjacent threads on adjacent words of device memory
      if (a.in_elem != 1) {
        t = g & tmask;
        ia = g >> a.log_tile;
      } else {
        ia = g & ((1u << log_q) - 1);
        t = g >> log_q;
      }
      base = (t << l) + ia;
      const int64_t gs = g0 + t;
      const bool live = gs < total;
      const int64_t r = gs >> a.log_seqs, s = gs & seq_mask;
      const uint64_t* row = a.in + r * a.in_row;
      const int64_t p0 = s * a.in_seq + ia * a.in_elem;
      const int64_t dp = a.in_elem << log_q;
      // word b's input scale and pass-2 twiddle, stepped along b
      uint64_t scale = a.pre_lo ? table_power(a.pre_lo, a.pre_hi,
                                              static_cast<uint32_t>(p0)) : 1;
      uint64_t twid = 1, twid_step = 1;
      if (a.tw_lo) {
        const uint32_t e = static_cast<uint32_t>(s) * ia;
        twid = table_power(a.tw_lo, a.tw_hi, e);
        twid_step = table_power(a.tw_lo, a.tw_hi,
                                static_cast<uint32_t>(s) << log_q);
      }
      static_for<R>([&](auto bc) {
        constexpr int b = decltype(bc)::value;
        const int64_t p = p0 + b * dp;
        uint64_t x = 0;
        if (live && p < a.n_in) x = row[p];
        if (a.pre_lo) {
          x = fmul(x, scale);
          if (b + 1 < R) scale = fmul(scale, a.pre_step);
        }
        if (a.tw_lo) {
          x = fmul(x, twid);
          if (b + 1 < R) twid = fmul(twid, twid_step);
        }
        v[bitrev(b, LR)] = x;
      });
    } else {
      uint32_t seg;
      if (kLast) {
        // adjacent threads on adjacent output words
        if (a.out_elem != 1) {
          t = g & tmask;
          xb = g >> a.log_tile;
        } else {
          xb = g & ((1u << (l - LR)) - 1);
          t = g >> (l - LR);
        }
        // xb = d0 + 2^lv0 d1 in output order is segment d0 2^lv1 + d1
        seg = lv1 ? ((xb & ((1u << lv0) - 1)) << lv1) + (xb >> lv0) : xb;
      } else {
        ia = g & ((1u << log_q) - 1);
        const uint32_t rest = g >> log_q;
        seg = rest & ((1u << (l - log_m)) - 1);
        t = rest >> (l - log_m);
      }
      base = (t << l) + (seg << log_m) + ia;
      static_for<R>([&](auto bc) {
        constexpr int b = decltype(bc)::value;
        v[bitrev(b, LR)] = sm[swz(base + (static_cast<uint32_t>(b) << log_q))];
      });
    }
    dft<LR>(v, a.rw);
    if (kLast) {
      const int64_t gs = g0 + t;
      if (gs >= total) continue;
      const int64_t r = gs >> a.log_seqs, s = gs & seq_mask;
      uint64_t* row = a.out + r * a.out_row;
      const int64_t p0 = s * a.out_seq + xb * a.out_elem;
      const int64_t dp = a.out_elem << (l - LR);
      uint64_t scale = a.post_lo ? table_power(a.post_lo, a.post_hi,
                                               static_cast<uint32_t>(p0)) : 1;
      static_for<R>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        if (a.post_lo) {
          row[p0 + k * dp] = fmul(v[k], scale);
          if (k + 1 < R) scale = fmul(scale, a.post_step);
        } else {
          row[p0 + k * dp] = canonical(v[k]);
        }
      });
    } else {
      if (kFirst) __syncthreads();  // the twiddle table is staged (G = 1)
      const uint64_t* tw = tws + tw_off + ia;
      static_for<R>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        const uint64_t y = k ? fmul(v[k], tw[k << log_q]) : v[k];
        sm[swz(base + (static_cast<uint32_t>(k) << log_q))] = y;
      });
    }
  }
}

template <bool kFirst, bool kLast>
__device__ __forceinline__ void level_of(int lr, const Pass& a, uint64_t* sm,
                                         const uint64_t* tws, int log_m,
                                         int tw_off) {
  const int lv0 = a.lv[0], lv1 = a.lv[2] ? a.lv[1] : 0;
  switch (lr) {
    case 0: level<0, kFirst, kLast>(a, sm, tws, log_m, tw_off, lv0, lv1); break;
    case 1: level<1, kFirst, kLast>(a, sm, tws, log_m, tw_off, lv0, lv1); break;
    case 2: level<2, kFirst, kLast>(a, sm, tws, log_m, tw_off, lv0, lv1); break;
    case 3: level<3, kFirst, kLast>(a, sm, tws, log_m, tw_off, lv0, lv1); break;
    default: level<4, kFirst, kLast>(a, sm, tws, log_m, tw_off, lv0, lv1);
  }
}

// K4: one pass over 2^log_tile sub-sequences a CTA, 16 words a thread.
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass_kernel(const __grid_constant__ Pass a) {
  extern __shared__ uint64_t sm[];  // the tile, then the levels' twiddles
  uint64_t* tws = sm + kE * blockDim.x;
  const int l = a.log_len;
  if (!a.lv[1]) {  // one level: device memory to registers and back
    level_of<true, true>(a.lv[0], a, sm, tws, l, 0);
    return;
  }
  for (int e = threadIdx.x; e < a.inner_words; e += blockDim.x) {
    tws[e] = __ldg(a.inner + e);
  }
  level<4, true, false>(a, sm, tws, l, 0, 0, 0);  // syncs before its twiddles
  __syncthreads();
  int log_m = l - a.lv[0];
  if (a.lv[2]) {
    level_of<false, false>(a.lv[1], a, sm, tws, log_m, 1 << l);
    __syncthreads();
    log_m -= a.lv[1];
  }
  level_of<false, true>(log_m, a, sm, tws, log_m, 0);
}

}  // namespace

extern "C" {

// Enqueue one pass of K4 on `stream` (see Pass for the arguments; `rw`
// the host's 8 roots, `lv` its 3 radix bits).
int ntt_pass_launch(const void* in, int64_t in_row, int64_t n_in, void* out,
                    int64_t out_row, int64_t rows, int log_seqs,
                    int64_t in_seq, int64_t in_elem, int64_t out_seq,
                    int64_t out_elem, const void* pre_lo, const void* pre_hi,
                    const void* post_lo, const void* post_hi,
                    uint64_t pre_step, uint64_t post_step,
                    const void* tw_lo, const void* tw_hi, const void* inner,
                    int inner_words, const uint64_t* rw, const int* lv,
                    int log_len, int log_tile, void* stream) {
  const int lv_sum = lv[0] + lv[1] + lv[2];
  const int64_t tile_words = int64_t(1) << (log_len + log_tile);
  const int64_t threads = tile_words / kE;
  const int64_t blocks = ((rows << log_seqs) + (int64_t(1) << log_tile) - 1)
                         >> log_tile;
  const bool bad_levels =
      lv_sum != log_len || lv[0] < 0 || lv[0] > 4 || lv[1] < 0 ||
      lv[1] > 4 || lv[2] < 0 || lv[2] > 4 || (lv[1] && lv[0] != 4) ||
      (lv[2] && !lv[1]) || (!lv[1] && lv[0] != log_len);
  if (log_len < 0 || log_len > kMaxLogLen || log_tile < 0 || bad_levels ||
      threads < 1 || threads > kMaxThreads ||
      tile_words != threads * kE || rows < 1 || log_seqs < 0 ||
      log_seqs > 24 || blocks > 0x7FFFFFFF || inner_words < 0 ||
      inner_words > kMaxInnerWords || (lv[1] && inner_words < (1 << log_len)) ||
      (pre_lo != nullptr) != (pre_hi != nullptr) ||
      (post_lo != nullptr) != (post_hi != nullptr) ||
      (tw_lo != nullptr) != (tw_hi != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pass a{static_cast<const uint64_t*>(in), in_row, n_in,
         static_cast<uint64_t*>(out), out_row, rows,
         in_seq, in_elem, out_seq, out_elem,
         static_cast<const uint64_t*>(pre_lo),
         static_cast<const uint64_t*>(pre_hi),
         static_cast<const uint64_t*>(post_lo),
         static_cast<const uint64_t*>(post_hi), pre_step, post_step,
         static_cast<const uint64_t*>(tw_lo),
         static_cast<const uint64_t*>(tw_hi),
         static_cast<const uint64_t*>(inner), inner_words, log_seqs,
         log_len, log_tile, {lv[0], lv[1], lv[2]}, {}};
  for (int j = 0; j < 8; ++j) a.rw[j] = rw[j];
  const int smem = static_cast<int>(sizeof(uint64_t)) *
                   static_cast<int>(tile_words + inner_words);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint64_t)) *
          (kE * kMaxThreads + kMaxInnerWords));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_pass_kernel<<<static_cast<unsigned int>(blocks),
                    static_cast<unsigned int>(threads), smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ntt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
