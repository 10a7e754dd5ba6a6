// The combined AIR quotient on Hopper (sm_90a): K3, the four constraint
// phases of the master AIR run at every row of a quotient domain or coset,
// each output weighted, each phase scaled by its zerofier inverse, the
// phases summed.
//
// K3 replaces no Pallas kernel: the JAX package compiles the same function
// with XLA, jax.jit over the quotient chunk function of
// triton_vm_tpu/stark/prover.py (:1185), which runs
// air/compile.py::run_tape_scan (:397), a fori_loop over the level tape,
// chunk by chunk.
//
// What bounds it on this card: integer multiplies. A row reads under 900
// words of input and runs about 11,000 Goldilocks products, so at every
// size the arithmetic, not the bytes, is the bound. What the design does
// about it:
//
// - One thread evaluates one row, and the row tape (air/compile.py::
//   quotient_row_tape, 8,419 instructions) is compiled, not interpreted:
//   ops/tape_codegen.py writes each instruction as a line of straight-line
//   code, its result a local variable, its operands resolved, constants
//   immediates. There is no dispatch, and ptxas keeps the values in
//   flight in registers. The generated units include this file and are
//   keyed by the hash of the tape, the generator and these sources
//   (ops/quotient_cuda.py::sources).
// - Straight-line code that no warp runs twice waits on instruction
//   fetch, so the tape is cut into segments of about 100 instructions at
//   points of low liveness, one kernel each, and every row of a launch
//   runs the same segment's code. A chunk of rows takes this file's first
//   kernel (the zerofier inverses), every segment kernel in order and its
//   last kernel (the output): about 100 launches a chunk.
// - A value that outlives its segment goes through the state array
//   (Args::state, QUOTIENT_STATE_WORDS words a row, row-fastest in device
//   memory, so a warp's accesses coalesce), stored once and loaded once by
//   each later segment that reads it. The caller sizes the chunk to the
//   state it can hold (ops/quotient_cuda.py::CHUNK_ROWS).
// - XFE products are out of line (__noinline__): inlined, the segments'
//   code doubles and the kernel slows on instruction fetch.
// - Inputs are read in place through their strides: main (columns, rows),
//   aux (component, column, row), so a strided or permuted view of an LDE
//   needs no copy; the next row is row (i + shift) % m.
// - The points x_i = offset g^(start + i) are formed here from the two
//   2^12-word tables of ops/gf.py::power_tables (no n-word table), the
//   zerofier inverses per row from x (three Fermat inversions).
// - Every output is folded into its phase's accumulator with its weight
//   as soon as it is produced. Every value the kernel writes is a
//   canonical field element.
//
// Interface: plain C, driven through ctypes (ops/quotient_cuda.py). The
// launcher enqueues on the given stream, allocates nothing, and returns
// cudaGetLastError() right after the last launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#ifndef QUOTIENT_STATE_WORDS
#error "QUOTIENT_STATE_WORDS: build the source ops/tape_codegen.py generates"
#endif
// Threads a CTA, the count every segment kernel's registers are budgeted
// for.
constexpr int kThreads = 128;

// One row's view of the inputs, read by the segments.
struct Row {
  const uint64_t* main;       // column c of this row: main[c * ms0]
  const uint64_t* next_main;  // of the next row
  int64_t ms0;
  const uint64_t* aux;        // component k of column c: aux[k as0 + c as1]
  const uint64_t* next_aux;
  int64_t as0, as1;
  const uint64_t* ch;         // (3, nch)
  int64_t nch;
  const uint64_t* w;          // (3, nw)
  int64_t nw;
};

// A launch's arguments, the same for every kernel of it (outside the
// anonymous namespace: the segments live in other translation units).
struct Args {
  const uint64_t* ch;       // (3, nch)
  int64_t nch;
  const uint64_t* w;        // (3, nw)
  int64_t nw;
  const uint64_t* main;     // (columns, m) through strides
  int64_t ms0, ms1;
  const uint64_t* aux;      // (3, columns, m) through strides
  int64_t as0, as1, as2;
  const uint64_t* x_lo;     // x_i = x_lo[i mod 2^12] x_hi[i >> 12]
  const uint64_t* x_hi;
  int64_t n, m, shift;
  int log2_h;               // trace domain length 2^log2_h
  uint64_t gen_inv;         // the trace domain generator's inverse
  uint64_t* out;            // (3, n)
  uint64_t* state;          // (QUOTIENT_STATE_WORDS, stride), row-fastest
  int64_t stride;           // rows a chunk holds
};

// Each kernel of a chunk of rows row0 .. row0 + rows - 1: thread t takes
// row row0 + t, its state words st[w * stride].
#define QUOTIENT_SEGMENT(name)                                          \
  __global__ void __launch_bounds__(kThreads)                           \
  name(const __grid_constant__ Args a, int64_t row0, int64_t rows)
#define QUOTIENT_ROW_SETUP()                                            \
  const int64_t t_ = static_cast<int64_t>(blockIdx.x) * blockDim.x +     \
                     threadIdx.x;                                       \
  if (t_ >= rows) return;                                               \
  const Row row_ = row_at(a, row0 + t_);                                \
  const Row* r = &row_;                                                 \
  uint64_t* st = a.state + t_;                                          \
  const int64_t stride = a.stride
#define S(w) st[static_cast<int64_t>(w) * stride]
#define LDX(w) (Xfe{{S(w), S((w) + 1), S((w) + 2)}})
#define STX(w, v)                                                       \
  do {                                                                  \
    const Xfe v_ = (v);                                                 \
    S(w) = v_.c[0];                                                     \
    S((w) + 1) = v_.c[1];                                               \
    S((w) + 2) = v_.c[2];                                               \
  } while (0)

namespace {

// st's fixed words, ops/tape_codegen.py's ACC, TOTAL and ZEROFIERS
constexpr int kAcc = 0, kTotal = 3, kZerofiers = 6;

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
__device__ __noinline__ Xfe xmul(const Xfe& a, const Xfe& b) {
  const uint64_t d0 = fmul(a.c[0], b.c[0]);
  const uint64_t d1 = fadd(fmul(a.c[0], b.c[1]), fmul(a.c[1], b.c[0]));
  const uint64_t d2 = fadd(fadd(fmul(a.c[0], b.c[2]), fmul(a.c[1], b.c[1])),
                           fmul(a.c[2], b.c[0]));
  const uint64_t d3 = fadd(fmul(a.c[1], b.c[2]), fmul(a.c[2], b.c[1]));
  const uint64_t d4 = fmul(a.c[2], b.c[2]);
  return {{fsub(d0, d3), fadd(d1, fsub(d3, d4)), fadd(d2, d4)}};
}

__device__ __noinline__ Xfe xscale(const Xfe& a, uint64_t s) {
  return {{fmul(a.c[0], s), fmul(a.c[1], s), fmul(a.c[2], s)}};
}

// -a for canonical a: the AIR's products by -1 (ops/tape_codegen.py).
__device__ __forceinline__ uint64_t fneg(uint64_t a) {
  return fsub(0, a);
}

__device__ __forceinline__ Xfe xneg(const Xfe& a) {
  return {{fneg(a.c[0]), fneg(a.c[1]), fneg(a.c[2])}};
}

__device__ __forceinline__ Xfe bxadd(const Xfe& a, uint64_t b) {
  return {{fadd(a.c[0], b), a.c[1], a.c[2]}};
}

__device__ __forceinline__ uint64_t in_main(const Row* r, int c) {
  return __ldg(r->main + c * r->ms0);
}

__device__ __forceinline__ uint64_t in_next_main(const Row* r, int c) {
  return __ldg(r->next_main + c * r->ms0);
}

__device__ __forceinline__ Xfe in_aux(const Row* r, int c) {
  const uint64_t* p = r->aux + c * r->as1;
  return {{__ldg(p), __ldg(p + r->as0), __ldg(p + 2 * r->as0)}};
}

__device__ __forceinline__ Xfe in_next_aux(const Row* r, int c) {
  const uint64_t* p = r->next_aux + c * r->as1;
  return {{__ldg(p), __ldg(p + r->as0), __ldg(p + 2 * r->as0)}};
}

__device__ __forceinline__ Xfe challenge(const Row* r, int c) {
  return {{__ldg(r->ch + c), __ldg(r->ch + r->nch + c),
           __ldg(r->ch + 2 * r->nch + c)}};
}

__device__ __forceinline__ Xfe weight(const Row* r, int k) {
  return {{__ldg(r->w + k), __ldg(r->w + r->nw + k),
           __ldg(r->w + 2 * r->nw + k)}};
}

__device__ __forceinline__ Row row_at(const Args& a, int64_t i) {
  const int64_t ni = (i + a.shift) % a.m;
  return Row{a.main + i * a.ms1, a.main + ni * a.ms1, a.ms0,
             a.aux + i * a.as2, a.aux + ni * a.as2, a.as0, a.as1,
             a.ch, a.nch, a.w, a.nw};
}

}  // namespace

#ifndef QUOTIENT_SEGMENTS_ONLY

// The generated segment kernels, in order (ops/tape_codegen.py).
extern const int kQuotientSegments;
extern const void* const kQuotientSegmentKernels[];

namespace {

// K3's first kernel of a chunk: the zerofier inverses of each row's point,
// init 1/(x - 1), cons 1/(x^h - 1), tran (x - g^-1)/(x^h - 1), term
// 1/(x - g^-1), and the accumulator and total cleared.
QUOTIENT_SEGMENT(quotient_rows_kernel) {
  QUOTIENT_ROW_SETUP();
  (void)r;
  const uint64_t x = table_power(a.x_lo, a.x_hi,
                                 static_cast<uint32_t>(row0 + t_));
  uint64_t xh = x;
  for (int k = 0; k < a.log2_h; ++k) xh = fmul(xh, xh);
  const uint64_t cons = finv(fsub(xh, 1));
  const uint64_t x_minus = fsub(x, a.gen_inv);
  S(kZerofiers) = finv(fsub(x, 1));
  S(kZerofiers + 1) = cons;
  S(kZerofiers + 2) = fmul(x_minus, cons);
  S(kZerofiers + 3) = finv(x_minus);
  for (int c = 0; c < 3; ++c) S(kAcc + c) = S(kTotal + c) = 0;
}

// K3's last kernel of a chunk: each row's total to the output.
QUOTIENT_SEGMENT(quotient_out_kernel) {
  QUOTIENT_ROW_SETUP();
  (void)r;
  for (int c = 0; c < 3; ++c) a.out[c * a.n + row0 + t_] = S(kTotal + c);
}

}  // namespace

extern "C" {

// K3's kernels launched per chunk of the rows (2 + the segments'), and
// the words of state a row holds.
int quotient_launches_per_chunk() { return kQuotientSegments + 2; }
int quotient_state_words() { return QUOTIENT_STATE_WORDS; }

// Enqueue K3 over rows 0 .. n - 1 on `stream`, `stride` rows a chunk:
// for each chunk the first kernel, every segment kernel in order, and the
// last, all reading and writing the chunk's words of `state` (stride x
// QUOTIENT_STATE_WORDS words, allocated by the caller). Blocks are sized
// so that a small chunk still spreads over every SM.
int quotient_rows_launch(const void* ch, int64_t nch, const void* w,
                         int64_t nw, const void* main, int64_t ms0,
                         int64_t ms1, const void* aux, int64_t as0,
                         int64_t as1, int64_t as2, const void* x_lo,
                         const void* x_hi, int64_t n, int64_t m,
                         int64_t shift, int log2_h, uint64_t gen_inv,
                         void* out, void* state, int64_t stride,
                         void* stream) {
  if (n > (int64_t(1) << 24) || stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint64_t*>(ch), nch,
         static_cast<const uint64_t*>(w), nw,
         static_cast<const uint64_t*>(main), ms0, ms1,
         static_cast<const uint64_t*>(aux), as0, as1, as2,
         static_cast<const uint64_t*>(x_lo),
         static_cast<const uint64_t*>(x_hi), n, m, shift, log2_h, gen_inv,
         static_cast<uint64_t*>(out), static_cast<uint64_t*>(state), stride};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int64_t row0 = 0; row0 < n; row0 += stride) {
    int64_t rows = n - row0 < stride ? n - row0 : stride;
    const int64_t spread = (rows + sms - 1) / sms;  // rows an SM, one wave
    int64_t threads = kThreads;
    if (threads > spread && spread >= 32) threads = spread;
    const dim3 grid(static_cast<unsigned int>((rows + threads - 1) / threads));
    const dim3 block(static_cast<unsigned int>(threads));
    void* args[] = {&a, &row0, &rows};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int k = -1; k <= kQuotientSegments; ++k) {
      const void* fn = k < 0 ? reinterpret_cast<const void*>(
                                   quotient_rows_kernel)
                       : k < kQuotientSegments ? kQuotientSegmentKernels[k]
                       : reinterpret_cast<const void*>(quotient_out_kernel);
      cudaError_t err = cudaLaunchKernel(fn, grid, block, args, 0, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* quotient_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // QUOTIENT_SEGMENTS_ONLY
