// Goldilocks arithmetic on Hopper, shared by K3 (csrc/quotient.cu and the
// row-tape source generated from it) and K4 (csrc/ntt.cu):
// p = 2^64 - 2^32 + 1, a field element a u64 in [0, p).
// Reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p); each carry chain is
// one `asm` block (csrc/tip5.cu keeps its own lazy variants for Tip5).
//
// ops/tip5_cuda.py::build hashes every header a source includes with
// #include "...", so an edit here rebuilds both kernels.

#pragma once

#include <cstdint>

namespace {

constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint32_t lo32(uint64_t x) {
  return static_cast<uint32_t>(x);
}

__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// (h * 2^64 + l) mod p for h < 2^32, as a u64 that need not be canonical
// (csrc/tip5.cu's reduce96).
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

// (hi * 2^64 + lo) mod p, as a u64 that need not be canonical
// (csrc/tip5.cu's reduce128).
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

// The canonical x mod p (csrc/tip5.cu's canonical).
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

// Field operations on canonical operands, canonical results.
__device__ __forceinline__ uint64_t fadd(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return canonical(s < a ? s + kEps : s);  // a + b - 2^64 < p: no carry
}

__device__ __forceinline__ uint64_t fsub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - kEps : d;  // a - b + p on a borrow
}

__device__ __forceinline__ uint64_t fmul(uint64_t a, uint64_t b) {
  return canonical(reduce128(a * b, __umul64hi(a, b)));
}

// Lazy words: a word stands for its value mod p anywhere in [0, 2^64).
// fmul takes any words and returns a canonical one; fsub takes any a and
// a canonical b (a - b + p >= 1 on a borrow) and so does add_lazy, which
// returns a word that need not be canonical (a + b - 2^64 + eps < 2^64 on a
// carry). `canonical` brings a lazy word back to [0, p).
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s < a ? s + kEps : s;
}

// The two-table power: base^e = lo[e mod 2^12] * hi[e >> 12] for e < 2^24,
// lo[j] = f base^j and hi[j] = base^(2^12 j) (ops/gf.py::power_tables), so
// lo[.] hi[.] = f base^e, with f the factor folded into lo.
constexpr int kPowBits = 12;

__device__ __forceinline__ uint64_t table_power(const uint64_t* lo,
                                                const uint64_t* hi,
                                                uint32_t e) {
  return fmul(__ldg(lo + (e & ((1u << kPowBits) - 1))),
              __ldg(hi + (e >> kPowBits)));
}

}  // namespace
