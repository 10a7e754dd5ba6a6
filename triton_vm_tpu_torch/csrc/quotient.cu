// The combined AIR quotient on Hopper (sm_90a): K3, the four constraint
// phases of the master AIR run at every row of a quotient domain or coset
// in one launch, each output weighted, each phase scaled by its zerofier
// inverse, the phases summed.
//
// K3 replaces no Pallas kernel: the JAX package compiles the same function
// with XLA, jax.jit over triton_vm_tpu/stark/prover.py::_quotient_chunk_fn
// (:1185), which runs air/compile.py::run_tape_scan (:397), a fori_loop
// over the level tape, chunk by chunk.
//
// What bounds it on this card: integer multiplies. A row reads under 900
// words of input and runs about 11,000 Goldilocks products, so at every
// size the arithmetic, not the bytes, is the bound. What this first design
// does about it is to run the whole stage as one launch instead of a few
// eager torch ops per (level, signature) group of the level tape:
//
// - One thread evaluates one row. It walks the row tape (air/compile.py::
//   compile_row_tape) instruction by instruction; every lane of a warp runs
//   the same instruction, so the dispatch never diverges, and the tape is
//   read warp-uniformly from global memory through the read-only cache.
// - The values in flight live in a register file of `reg_words` words a
//   row (311 for the master AIR: 95 base registers and 72 XFE registers of
//   3 words), a per-thread local array of kMaxRegWords words that the
//   compiler puts in local memory (cached in L1 and L2). A file in dynamic
//   shared memory, strided by thread, holds only about 93 rows an SM and
//   ran 4.8x slower at 2^16 rows on an H100 (PERF.md section 6).
// - Inputs are read in place through their strides: main (columns, rows),
//   aux (component, column, row), so a strided or permuted view of an LDE
//   needs no copy; the next row is row (i + shift) % m.
// - Every output is folded into its phase's accumulator with its weight
//   as soon as it is produced; the zerofier inverses are computed per row
//   from xs (three Fermat inversions).
// - Every value the kernel stores or writes is a canonical field element.
//
// Interface: plain C, driven through ctypes (ops/quotient_cuda.py). The
// launcher enqueues on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

// The register file, words a row; ops/quotient_cuda.py mirrors it as
// MAX_REG_WORDS and refuses larger tapes.
constexpr int kMaxRegWords = 384;
constexpr int kThreads = 128;

// air/compile.py's operand kinds and instructions
enum Kind { kBReg, kXReg, kMain, kNextMain, kAux, kNextAux, kChallenge,
            kBConst, kXConst };
enum Op { kBBAdd, kBBMul, kBXAdd, kBXMul, kXXAdd, kXXMul, kFoldB, kFoldX,
          kPhaseEnd };

__device__ __forceinline__ uint64_t finv(uint64_t a) {  // a^(p - 2); 0 -> 0
  // p - 2 = 2^64 - 2^32 - 1: bits 0..31 and 33..63 set
  uint64_t r = 1, b = a;
  for (int k = 0; k < 64; ++k) {
    if (k != 32) r = fmul(r, b);
    b = fmul(b, b);
  }
  return r;
}

struct Xfe {
  uint64_t c[3];
};

__device__ __forceinline__ Xfe xadd(const Xfe& a, const Xfe& b) {
  return {{fadd(a.c[0], b.c[0]), fadd(a.c[1], b.c[1]),
           fadd(a.c[2], b.c[2])}};
}

// Schoolbook product reduced by x^3 = x - 1 (ops/gfx.py::mul).
__device__ __forceinline__ Xfe xmul(const Xfe& a, const Xfe& b) {
  const uint64_t d0 = fmul(a.c[0], b.c[0]);
  const uint64_t d1 = fadd(fmul(a.c[0], b.c[1]), fmul(a.c[1], b.c[0]));
  const uint64_t d2 = fadd(fadd(fmul(a.c[0], b.c[2]), fmul(a.c[1], b.c[1])),
                           fmul(a.c[2], b.c[0]));
  const uint64_t d3 = fadd(fmul(a.c[1], b.c[2]), fmul(a.c[2], b.c[1]));
  const uint64_t d4 = fmul(a.c[2], b.c[2]);
  return {{fsub(d0, d3), fadd(d1, fsub(d3, d4)), fadd(d2, d4)}};
}

__device__ __forceinline__ Xfe xscale(const Xfe& a, uint64_t s) {
  return {{fmul(a.c[0], s), fmul(a.c[1], s), fmul(a.c[2], s)}};
}

struct Args {
  const int4* code;         // (n_code, 4): op, dst, a, b
  int64_t n_code;
  const uint64_t* bconsts;  // (nbc,)
  const uint64_t* xconsts;  // (nxc, 3)
  const uint64_t* ch;       // (3, nch)
  int64_t nch;
  const uint64_t* w;        // (3, nw)
  int64_t nw;
  const uint64_t* main;     // (columns, m) through strides
  int64_t ms0, ms1;
  const uint64_t* aux;      // (3, columns, m) through strides
  int64_t as0, as1, as2;
  const uint64_t* xs;       // (n,)
  int64_t n, m, shift;
  int log2_h;               // trace domain length 2^log2_h
  uint64_t gen_inv;         // the trace domain generator's inverse
  int nbregs;               // base registers; XFE register r at word
                            // nbregs + 3 r
  uint64_t* out;            // (3, n)
};

// K3: thread i evaluates row i.
__global__ void __launch_bounds__(kThreads)
quotient_rows_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= a.n) return;
  uint64_t reg[kMaxRegWords];
  const int64_t ni = (i + a.shift) % a.m;
  auto ldb = [&](int opnd) -> uint64_t {
    const int idx = opnd & 0xFFFF;
    switch (opnd >> 16) {
      case kBReg: return reg[idx];
      case kMain: return a.main[idx * a.ms0 + i * a.ms1];
      case kNextMain: return a.main[idx * a.ms0 + ni * a.ms1];
      default: return __ldg(a.bconsts + idx);  // kBConst
    }
  };
  auto ldx = [&](int opnd) -> Xfe {
    const int idx = opnd & 0xFFFF;
    Xfe v;
    switch (opnd >> 16) {
      case kXReg:
#pragma unroll
        for (int c = 0; c < 3; ++c) v.c[c] = reg[a.nbregs + 3 * idx + c];
        break;
      case kAux:
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v.c[c] = a.aux[c * a.as0 + idx * a.as1 + i * a.as2];
        }
        break;
      case kNextAux:
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v.c[c] = a.aux[c * a.as0 + idx * a.as1 + ni * a.as2];
        }
        break;
      case kChallenge:
#pragma unroll
        for (int c = 0; c < 3; ++c) v.c[c] = __ldg(a.ch + c * a.nch + idx);
        break;
      default:  // kXConst
#pragma unroll
        for (int c = 0; c < 3; ++c) v.c[c] = __ldg(a.xconsts + 3 * idx + c);
    }
    return v;
  };
  auto stx = [&](int r, const Xfe& v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) reg[a.nbregs + 3 * r + c] = v.c[c];
  };
  auto weight = [&](int k) -> Xfe {
    return {{__ldg(a.w + k), __ldg(a.w + a.nw + k),
             __ldg(a.w + 2 * a.nw + k)}};
  };

  // zerofier inverses: init 1/(x - 1), cons 1/(x^h - 1), tran
  // (x - g^-1)/(x^h - 1), term 1/(x - g^-1)
  const uint64_t x = a.xs[i];
  uint64_t xh = x;
  for (int k = 0; k < a.log2_h; ++k) xh = fmul(xh, xh);
  uint64_t zi[4];
  zi[0] = finv(fsub(x, 1));
  zi[1] = finv(fsub(xh, 1));
  const uint64_t x_minus = fsub(x, a.gen_inv);
  zi[2] = fmul(x_minus, zi[1]);
  zi[3] = finv(x_minus);

  Xfe acc{}, total{};
  for (int64_t pc = 0; pc < a.n_code; ++pc) {
    const int4 ins = __ldg(a.code + pc);
    switch (ins.x) {
      case kBBAdd: reg[ins.y] = fadd(ldb(ins.z), ldb(ins.w)); break;
      case kBBMul: reg[ins.y] = fmul(ldb(ins.z), ldb(ins.w)); break;
      case kBXAdd: {
        Xfe v = ldx(ins.z);
        v.c[0] = fadd(v.c[0], ldb(ins.w));
        stx(ins.y, v);
        break;
      }
      case kBXMul: stx(ins.y, xscale(ldx(ins.z), ldb(ins.w))); break;
      case kXXAdd: stx(ins.y, xadd(ldx(ins.z), ldx(ins.w))); break;
      case kXXMul: stx(ins.y, xmul(ldx(ins.z), ldx(ins.w))); break;
      case kFoldB: acc = xadd(acc, xscale(weight(ins.y), ldb(ins.z))); break;
      case kFoldX: acc = xadd(acc, xmul(weight(ins.y), ldx(ins.z))); break;
      default:  // kPhaseEnd
        total = xadd(total, xscale(acc, zi[ins.y & 3]));
        acc = Xfe{};
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) a.out[c * a.n + i] = total.c[c];
}

}  // namespace

extern "C" {

// Enqueue K3 over rows 0 .. n - 1 on `stream`. reg_words is the tape's
// register file (words a row). Blocks are sized so that a small n still
// spreads over every SM.
int quotient_rows_launch(const void* code, int64_t n_code,
                         const void* bconsts, const void* xconsts,
                         const void* ch, int64_t nch, const void* w,
                         int64_t nw, const void* main, int64_t ms0,
                         int64_t ms1, const void* aux, int64_t as0,
                         int64_t as1, int64_t as2, const void* xs, int64_t n,
                         int64_t m, int64_t shift, int log2_h,
                         uint64_t gen_inv, int nbregs, int reg_words,
                         void* out, void* stream) {
  Args a{static_cast<const int4*>(code), n_code,
         static_cast<const uint64_t*>(bconsts),
         static_cast<const uint64_t*>(xconsts),
         static_cast<const uint64_t*>(ch), nch,
         static_cast<const uint64_t*>(w), nw,
         static_cast<const uint64_t*>(main), ms0, ms1,
         static_cast<const uint64_t*>(aux), as0, as1, as2,
         static_cast<const uint64_t*>(xs), n, m, shift, log2_h, gen_inv,
         nbregs, static_cast<uint64_t*>(out)};
  if (reg_words > kMaxRegWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t spread = (n + sms - 1) / sms;  // rows per SM in one wave
  int64_t threads = kThreads;
  if (threads > spread && spread >= 32) threads = spread;
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  quotient_rows_kernel<<<blocks, static_cast<unsigned int>(threads), 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* quotient_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
