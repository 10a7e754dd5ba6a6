// Tip5 on Hopper (sm_90a): the batched permutation (K1) and the per-row
// variable-length sponge (K2) behind every Merkle commitment of the prover.
//
// K1 `tip5_permutation_kernel` replaces the Pallas kernel
//   triton_vm_tpu/ops/tip5_pallas.py::permutation (pallas_call at :157);
// K2 `tip5_sponge_rows_kernel` replaces
//   triton_vm_tpu/ops/tip5_pallas.py::sponge_absorb_rows_t (pallas_call at :233).
//
// What bounds them on this card: integer instruction issue, not bytes. A
// permutation reads and writes 256 bytes (K1) or reads 80 bytes per
// absorbed chunk (K2) and runs 5 rounds of S-box, MDS and round constants
// on 16 Goldilocks words. One thread owns one state, all in registers;
// the SASS of a round (tools/tip5_probe.py) is what the design counts:
//
// - Reductions are branch-free carry chains, each in one asm statement
//   (the carry flag does not live from one asm statement to the next),
//   and lazy: a word may be any u64 representative of its field element
//   inside a permutation and is made canonical only where the value, not
//   its class, matters: the S-box's byte split and the permutation's
//   output.
// - The MDS layer is the direct 16 x 16 circulant on the 32-bit halves
//   of the words, as FP64 FMAs: every product and partial sum is an
//   integer below 2^52, exact in a double, so the otherwise idle FP64
//   pipe does the 512 multiply-adds of a round and the integer pipes
//   keep the rest. ops/tip5_cuda.py::_mds does the same in float64.
// - The Montgomery steps of the S-box multiply by R = 2^32 - 1 and by
//   R^-1 = -2^32 (mod p), so they are shifts and one reduction each.
// - The 256-entry S-box byte table sits in shared memory (8 gathers a
//   word; GPUs gather cheaply, so the TPU's arithmetic S-box is not
//   needed); round constants sit in constant memory (uniform reads).
// - K2 loads chunk c + 1 of its row while it permutes chunk c, and reads
//   each row through a row and a column stride, so it hashes a
//   column-major LDE in place (neighbouring threads read neighbouring
//   rows) and appends the 1-then-zeros padding itself.
//
// Interface: plain C, driven through ctypes (ops/tip5_cuda.py). Each
// launcher enqueues on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kRounds = 5;
constexpr int kState = 16;
constexpr int kRate = 10;
constexpr int kThreads = 128;

// tip5.MDS_MATRIX_FIRST_COLUMN, as doubles for the FP64 pipe
__constant__ double kMds[kState] = {
    61402, 1108, 28750, 33823, 7454, 43244, 53865, 12034,
    56951, 27521, 41351, 40901, 12021, 59689, 26798, 17845};

// tip5.ROUND_CONSTANTS, round-major
__constant__ uint64_t kRoundConstants[kRounds * kState] = {
    // round 0
    0xBD2A3DEB61AB60DEull, 0xEA7DF21AD9547ED2ull, 0x900B3677A1DE063Full, 0x1B46887E876C8677ull,
    0xD364D977889CFB97ull, 0xDC8DFAC843699F02ull, 0x375C405D7190DB58ull, 0x27924006D2B0D4B1ull,
    0x78DD1172D483CD38ull, 0x3346C66244882A56ull, 0xB0249B279F498AA5ull, 0x94CD51BE79338D4Dull,
    0xB0E0DC7052C5B218ull, 0xF8DCC4D248ADAD95ull, 0x68E3C635FEC868B7ull, 0xD7D06B3FFB6B0D8Cull,
    // round 1
    0xF3500DEA20EF032Aull, 0x4865BF175BBA5803ull, 0xD5F7FE3027287A27ull, 0xA57333F44E193412ull,
    0x8726E153A977EAE2ull, 0x3014A98463FC191Bull, 0xBA145461AF39B212ull, 0x03AB70105933202Full,
    0x3D90B7EEBFCF71E5ull, 0x386322B1CC520BFDull, 0x27C2C8DAF774F675ull, 0x4FCB83F50309BC6Aull,
    0x5E6D5CE8275F3CB3ull, 0xECC2F6592C8F905Cull, 0x837F532461E609B4ull, 0xB2B1F6B95C92C93Cull,
    // round 2
    0xC0027AF556411DC1ull, 0x16E18C885FC2A26Cull, 0x8880EF183D9F2BF3ull, 0xB2930BDB5CA88C45ull,
    0x9C2EC8322E1C1553ull, 0xE5B05EAF3220A674ull, 0xA49CC6AE4B861C4Eull, 0x11708E0AEB86EBD7ull,
    0xC09DE92BBC3902E0ull, 0x929B3C79516BCBC1ull, 0xE006E5BF738F27D1ull, 0x2D9E1EC0EAC8EA38ull,
    0x0984D8D94BF937C5ull, 0x4959273C220E6747ull, 0xFE1D934207E796FAull, 0x2B9B9298F2F6DD73ull,
    // round 3
    0x07A1F5A67D6E3A41ull, 0x4407593EE73743D9ull, 0x9F054720EF802E59ull, 0x78D4B711336E6AA6ull,
    0xADC638AEF3C8B228ull, 0xA4D6D3E86AFB2114ull, 0x9D4808E725531968ull, 0x369804DF3866D0EFull,
    0xE6DBD9A9D2215024ull, 0x8ED22CA212EE85B2ull, 0x397BB882FCD23EB6ull, 0xEB8F8786D7277531ull,
    0x9999D4CDAFF543B5ull, 0xF382A61217F192D6ull, 0x49C37260B026ADC1ull, 0x3FF8918CE35C1019ull,
    // round 4
    0x2E7DF8B76080BD07ull, 0xF5DBAC250B8A28B9ull, 0x853C3727AE9DA4CCull, 0xB2F1F5F3D9E5A26Dull,
    0x3FCE22012D337847ull, 0x6B5A3E6DB7EEE347ull, 0x171582CD59DDE50Dull, 0xC0C0B3095EE62A8Aull,
    0x665B25C6F6A203D2ull, 0x3099AED93B6AE69Full, 0x801DF6092BE69C38ull, 0x8066AD0CDFFF43CDull,
    0x8AF9D44A5F4FDC6Bull, 0xD80219CD97C0D762ull, 0x10C9CEBA14148EBBull, 0x539BD4C3F2F24474ull,
};

__device__ __forceinline__ uint32_t lo32(uint64_t x) {
  return static_cast<uint32_t>(x);
}

__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// (h * 2^64 + l) mod p for h < 2^32, as a u64 that need not be
// canonical. With 2^64 = eps: r = l + h * eps, plus eps on a carry (r <
// h * eps < 2^64 - 2^33 then, so it cannot carry again); h * eps =
// h * 2^32 - h is a subtraction.
__device__ __forceinline__ uint64_t reduce96(uint64_t l, uint32_t h) {
  uint32_t r0, r1, m;
  asm("{\n\t"
      ".reg .u32 u0, u1;\n\t"
      "sub.cc.u32  u0, 0, %5;\n\t"  // (u1, u0) = h * eps
      "subc.u32    u1, %5, 0;\n\t"
      "add.cc.u32  %0, %3, u0;\n\t"
      "addc.cc.u32 %1, %4, u1;\n\t"
      "addc.u32    %2, 0, 0;\n\t"
      "neg.s32     %2, %2;\n\t"     // m = carry ? 2^32 - 1 : 0
      "add.cc.u32  %0, %0, %2;\n\t"
      "addc.u32    %1, %1, 0;\n\t"
      "}"
      : "=&r"(r0), "=&r"(r1), "=&r"(m)
      : "r"(lo32(l)), "r"(hi32(l)), "r"(h));
  return join(r0, r1);
}

// (hi * 2^64 + lo) mod p, as a u64 that need not be canonical. With
// 2^96 = -1: t = lo - hi[63:32], less eps on a borrow (t >= 2^64 - 2^32
// + 1 then, so it cannot borrow again), and then reduce96(t, hi[31:0]).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint32_t t0, t1, m;
  asm("{\n\t"
      "sub.cc.u32  %0, %3, %5;\n\t"
      "subc.cc.u32 %1, %4, 0;\n\t"
      "subc.u32    %2, 0, 0;\n\t"   // m = borrow ? 2^32 - 1 : 0
      "sub.cc.u32  %0, %0, %2;\n\t"
      "subc.u32    %1, %1, 0;\n\t"
      "}"
      : "=&r"(t0), "=&r"(t1), "=&r"(m)
      : "r"(lo32(lo)), "r"(hi32(lo)), "r"(hi32(hi)));
  return reduce96(join(t0, t1), lo32(hi));
}

// The canonical x mod p: x - p = x + eps (mod 2^64), and that add
// carries exactly when x >= p.
__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 t0, t1, c;\n\t"
      ".reg .pred q;\n\t"
      "add.cc.u32  t0, %2, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t1, %3, 0;\n\t"
      "addc.u32    c, 0, 0;\n\t"
      "setp.ne.u32 q, c, 0;\n\t"
      "selp.b32    %0, t0, %2, q;\n\t"
      "selp.b32    %1, t1, %3, q;\n\t"
      "}"
      : "=&r"(r0), "=&r"(r1)
      : "r"(lo32(x)), "r"(hi32(x)));
  return join(r0, r1);
}

// a + b mod p for any u64 a and a canonical b, not canonical: plus eps on
// a carry (a + b - 2^64 < p then, so it cannot carry again).
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1, m;
  asm("{\n\t"
      "add.cc.u32  %0, %3, %5;\n\t"
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32    %2, 0, 0;\n\t"
      "neg.s32     %2, %2;\n\t"
      "add.cc.u32  %0, %0, %2;\n\t"
      "addc.u32    %1, %1, 0;\n\t"
      "}"
      : "=&r"(r0), "=&r"(r1), "=&r"(m)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(r0, r1);
}

__device__ __forceinline__ uint64_t mulmod(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// tip5.LOOKUP_TABLE[i] = ((i + 1)^3 mod 257) - 1, built per block.
__device__ __forceinline__ void fill_lookup(uint8_t* lut) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t t = i + 1;
    lut[i] = static_cast<uint8_t>((t * t * t) % 257u - 1u);
  }
  __syncthreads();
}

// Split-and-lookup: into Montgomery form (x * R, R = 2^32 - 1, so x * 2^32
// - x as 128 bits), the byte map on the canonical value, back out (times
// R^-1 = -2^32 mod p). The result lies in (0, p].
__device__ __forceinline__ uint64_t split_and_lookup(uint64_t x,
                                                     const uint8_t* lut) {
  const uint64_t shifted = x << 32;
  const uint64_t raw = canonical(reduce96(
      shifted - x, hi32(x) - (shifted < x ? 1 : 0)));
  uint64_t out = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out |= static_cast<uint64_t>(lut[(raw >> (8 * k)) & 0xFF]) << (8 * k);
  }
  return kP - canonical(reduce96(out << 32, hi32(out)));
}

__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  const uint64_t x2 = mulmod(x, x);
  const uint64_t x4 = mulmod(x2, x2);
  return mulmod(mulmod(x4, x2), x);
}

// c * x for one vector of 32-bit halves x, c = kMds: out_i = sum_k c_k
// x_{(i - k) mod 16}. A product is below 2^16 * 2^32 = 2^48 and a sum of
// 16 below 2^52 (sum_k c_k < 2^20), integers a double's 53-bit
// significand holds exactly, so each FMA is exact in any order.
__device__ __forceinline__ void mds_half(const double (&x)[kState],
                                         uint64_t (&out)[kState]) {
#pragma unroll
  for (int i = 0; i < kState; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < kState; ++k) {
      acc = fma(kMds[k], x[(i - k) & (kState - 1)], acc);
    }
    out[i] = __double2ull_rn(acc);
  }
}

// out_i = sum_k c_k s_{(i - k) mod 16} mod p: both halves convolved, the
// halves' results a, b (< 2^52 each) joined into a + b * 2^32 < 2^84,
// one reduction.
__device__ __forceinline__ void mds(uint64_t (&s)[kState]) {
  double x[kState];
  uint64_t lo[kState], hi[kState];
#pragma unroll
  for (int j = 0; j < kState; ++j) x[j] = __uint2double_rn(lo32(s[j]));
  mds_half(x, lo);
#pragma unroll
  for (int j = 0; j < kState; ++j) x[j] = __uint2double_rn(hi32(s[j]));
  mds_half(x, hi);
#pragma unroll
  for (int i = 0; i < kState; ++i) {
    const uint64_t l = lo[i] + (hi[i] << 32);
    s[i] = reduce96(l, hi32(hi[i]) + (l < lo[i] ? 1 : 0));
  }
}

// The permutation; s may hold any u64 representatives, and leaves
// canonical.
__device__ __forceinline__ void permute(uint64_t (&s)[kState],
                                        const uint8_t* lut) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = split_and_lookup(s[i], lut);
#pragma unroll
    for (int i = 4; i < kState; ++i) s[i] = pow7(s[i]);
    mds(s);
#pragma unroll
    for (int i = 0; i < kState; ++i) {
      s[i] = add_lazy(s[i], kRoundConstants[r * kState + i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kState; ++i) s[i] = canonical(s[i]);
}

// K1: state (16, B), contiguous; thread b permutes column b.
__global__ void __launch_bounds__(kThreads)
tip5_permutation_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, int64_t batch) {
  __shared__ uint8_t lut[256];
  fill_lookup(lut);
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t s[kState];
#pragma unroll
  for (int i = 0; i < kState; ++i) s[i] = in[i * batch + b];
  permute(s, lut);
#pragma unroll
  for (int i = 0; i < kState; ++i) out[i * batch + b] = s[i];
}

// Chunk c of a row of n elements, padded with 1 then zeros.
__device__ __forceinline__ void load_chunk(const uint64_t* row, int64_t c,
                                           int64_t n, int64_t col_stride,
                                           uint64_t (&chunk)[kRate]) {
#pragma unroll
  for (int i = 0; i < kRate; ++i) {
    const int64_t j = c * kRate + i;
    chunk[i] = j < n ? row[j * col_stride] : (j == n ? 1ull : 0ull);
  }
}

// K2: row b holds elements rows[b * row_stride + j * col_stride], j < n.
// Zero-capacity sponge over the row padded with 1 then zeros to a
// multiple of RATE; digest (5, B) = state[0..5]. The next chunk's loads
// are in flight while this one is permuted.
__global__ void __launch_bounds__(kThreads)
tip5_sponge_rows_kernel(const uint64_t* __restrict__ rows, int64_t n,
                        int64_t batch, int64_t row_stride, int64_t col_stride,
                        uint64_t* __restrict__ out) {
  __shared__ uint8_t lut[256];
  fill_lookup(lut);
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint64_t* row = rows + b * row_stride;
  uint64_t s[kState], next[kRate];
#pragma unroll
  for (int i = 0; i < kState; ++i) s[i] = 0;
  const int64_t chunks = (n + kRate) / kRate;  // ceil((n + 1) / RATE)
  load_chunk(row, 0, n, col_stride, next);
  for (int64_t c = 0; c < chunks; ++c) {
#pragma unroll
    for (int i = 0; i < kRate; ++i) s[i] = next[i];
    if (c + 1 < chunks) load_chunk(row, c + 1, n, col_stride, next);
    permute(s, lut);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i * batch + b] = s[i];
}

unsigned int blocks_for(int64_t batch) {
  return static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int tip5_permutation_launch(const void* in, void* out, int64_t batch,
                            void* stream) {
  tip5_permutation_kernel<<<blocks_for(batch), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}

int tip5_sponge_rows_launch(const void* rows, int64_t n, int64_t batch,
                            int64_t row_stride, int64_t col_stride, void* out,
                            void* stream) {
  tip5_sponge_rows_kernel<<<blocks_for(batch), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(rows), n, batch, row_stride, col_stride,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tip5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
