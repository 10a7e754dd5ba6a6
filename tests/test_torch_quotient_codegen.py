"""K3's source generator (triton_vm_tpu_torch/ops/tape_codegen.py) on the
CPU: the row tape compiled to straight-line code in segments.

The kernel runs only on a card, so what its source computes is checked
here three ways: the segments and their live-in and live-out sets cover
the tape and every read; a torch re-enactment of the segmented schedule
(each segment seeing only its own values and the state words it loads,
stale words elsewhere) equals K3's plain version,
`quotient_cuda.quotients_on_rows_plain`, on 2^8 random rows with a
permuted aux view and a mesh shard's halo; and the generated body itself,
compiled with the host's C++ compiler (the field helpers of
csrc/quotient.cu written with unsigned __int128), does too. The kernel
against its plain version on the card is in chip_smoke.py and
tests/test_torch_cuda.py."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from triton_vm_tpu_torch.air import compile as aircomp
from triton_vm_tpu_torch.fields import bfe
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf, gfx, quotient_cuda, tape_codegen

torch.set_num_threads(2)

ROWS = 1 << 8
HALO = 8


@pytest.fixture(scope="module")
def tape():
    return aircomp.quotient_row_tape()


@pytest.fixture(scope="module")
def inputs(tape):
    """K3's arguments for ROWS random rows at the master AIR's widths:
    main (379, M), aux a permuted view of (91, 3, M) storage, M = ROWS +
    HALO (a shard's block and halo, next rows HALO ahead), random points,
    challenges and weights."""
    rng = np.random.default_rng(0xC0DE)
    m = ROWS + HALO

    def draw(shape):
        return gf.from_u64(rng.integers(0, P, shape, dtype=np.uint64))

    gen = int(rng.integers(2, P, dtype=np.uint64))
    return dict(
        main=draw((379, m)), aux=draw((91, 3, m)).permute(1, 0, 2),
        points=quotient_cuda.Points(gen, 7, ROWS, start=3), shift=HALO,
        trace_len=1 << 5,
        gen_inv=bfe.inv(bfe.primitive_root_of_unity(1 << 5)),
        ch=draw((3, 63)), ws=draw((3, tape.num_weights)))


@pytest.fixture(scope="module")
def want(tape, inputs):
    return quotient_cuda.quotients_on_rows_plain(tape, **inputs)


@pytest.mark.parametrize("target", [150, tape_codegen.SEGMENT_INSTRUCTIONS])
def test_generated_source_is_deterministic(tape, target):
    """The same tape gives the same source, one kernel a segment, as the
    units nvcc compiles in parallel: the kernel's unit declares every
    segment kernel and lists them in order; each other unit defines a run
    of them, every segment once."""
    k = len(tape_codegen.segments(tape, target))
    gen = tape_codegen.generate(tape, target)
    assert gen == tape_codegen.generate(tape, target)
    assert len(gen.functions) == k
    assert all(f.count("QUOTIENT_ROW_SETUP();") == 1 for f in gen.functions)
    units = tape_codegen.cuda_sources(tape, target, parts=4)
    assert all(u.count("#include \"quotient.cu\"") == 1 for u in units)
    assert units == tape_codegen.cuda_sources(tape, target, parts=4)
    assert len(units) == 5 and "QUOTIENT_SEGMENTS_ONLY" not in units[0]
    assert f"kQuotientSegments = {k};" in units[0]
    defined = [u.count("QUOTIENT_ROW_SETUP();") for u in units[1:]]
    assert sum(defined) == k and all(defined)
    for j in range(k):
        assert sum(f"QUOTIENT_SEGMENT(seg_{j}) {{" in u
                   for u in units[1:]) == 1
        assert f"reinterpret_cast<const void*>(seg_{j})," in units[0]


def test_source_path_is_keyed_by_the_tape_and_sources(tape, tmp_path,
                                                      monkeypatch):
    from triton_vm_tpu_torch.ops import tip5_cuda

    monkeypatch.setattr(tip5_cuda, "BUILD_DIR", tmp_path)
    a = quotient_cuda.sources(tape)
    assert a == quotient_cuda.sources(tape)
    assert {p.parent for p in a} == {tmp_path}
    assert len(a) == quotient_cuda.PARTS + 1
    assert [p.read_text() for p in a] == tape_codegen.cuda_sources(tape)
    assert quotient_cuda.sources(tape, 150)[0] != a[0]
    edited = tmp_path / "csrc" / "quotient.cu"
    edited.parent.mkdir()
    edited.write_text(quotient_cuda._SRC.read_text() + "// edited\n")
    monkeypatch.setattr(quotient_cuda, "_SRC", edited)
    assert quotient_cuda.sources(tape)[0] != a[0]


@pytest.mark.parametrize("target", [150, tape_codegen.SEGMENT_INSTRUCTIONS])
def test_segments_cover_the_tape(tape, target):
    """The segments tile the tape; a segment's live-in set is exactly the
    values it reads that earlier segments computed, its live-out set the
    values it computes that later segments read; no two values whose
    lives overlap share a word of st, and none touches the fixed words."""
    reads, width = tape_codegen.values(tape)
    segs = tape_codegen.segments(tape, target)
    assert segs[0].start == 0 and segs[-1].stop == len(tape.code)
    assert all(a.stop == b.start for a, b in zip(segs, segs[1:]))
    assert max(s.stop - s.start for s in segs) <= target + target // 2
    seg_of = {}
    for k, s in enumerate(segs):
        for i in range(s.start, s.stop):
            seg_of[i] = k
    for k, s in enumerate(segs):
        ins = {v for i in range(s.start, s.stop) for kind, v in reads[i]
               if kind == "v" and seg_of[v] < k}
        outs = {v for i in range(s.stop, len(reads)) for kind, v in reads[i]
                if kind == "v" and seg_of[v] == k}
        assert set(s.live_in) == ins and set(s.live_out) == outs
    gen = tape_codegen.generate(tape, target)
    crossing = {v for s in segs for v in s.live_out}
    assert set(gen.slots) == crossing
    last = {}
    for k, s in enumerate(segs):
        for v in s.live_in:
            last[v] = max(last.get(v, 0), min(
                i for i in range(s.start, s.stop)
                if ("v", v) in reads[i]))
    words = {}
    for v, at in gen.slots.items():
        assert at >= tape_codegen.FIXED_WORDS
        assert at + width[v] <= gen.state_words
        for w in range(at, at + width[v]):
            words.setdefault(w, []).append((v, last[v]))
    for lives in words.values():
        lives.sort()
        for (_, end), (start, _) in zip(lives, lives[1:]):
            assert start >= end


def _reenact(tape, inp, target):
    """The generated schedule in torch over all rows at once: each segment
    starts from nothing but st (stale words where nothing was stored),
    loads its live-in values from their slots, stores its live-out values
    right after computing them, and keeps the accumulator and the total
    in st's fixed words."""
    reads, width = tape_codegen.values(tape)
    gen = tape_codegen.generate(tape, target)
    main, aux, ch, ws = inp["main"], inp["aux"], inp["ch"], inp["ws"]
    N, M = inp["points"].n, main.shape[1]
    nidx = (torch.arange(N) + inp["shift"]) % M
    st = torch.full((gen.state_words, N), 0x5555AAAA, dtype=torch.int64)
    st[:tape_codegen.FIXED_WORDS] = 0
    st[tape_codegen.ZEROFIERS:tape_codegen.ZEROFIERS + 4] = \
        quotient_cuda.zerofier_inverses(inp["points"].tensor("cpu"),
                                        inp["trace_len"], inp["gen_inv"])
    bconsts = gf.from_u64(tape.bconsts)
    xconsts = gfx.from_u64(tape.xconsts)
    A, T = tape_codegen.ACC, tape_codegen.TOTAL

    def leaf(w):
        kind, idx = w >> 16, w & 0xFFFF
        return {aircomp.MAIN: lambda: main[idx, :N],
                aircomp.NEXT_MAIN: lambda: main[idx, nidx],
                aircomp.AUX: lambda: aux[:, idx, :N],
                aircomp.NEXT_AUX: lambda: aux[:, idx, nidx],
                aircomp.CHALLENGE: lambda: ch[:, idx, None].expand(3, N),
                aircomp.BCONST: lambda: bconsts[idx].expand(N),
                aircomp.XCONST: lambda: xconsts[:, idx, None].expand(3, N),
                }[kind]()

    code = tape.code.tolist()
    for s in gen.segments:
        env = {}
        acc = st[A:A + 3].clone()
        for i in range(s.start, s.stop):
            args = []
            for kind, v in reads[i]:
                if kind == "leaf":
                    args.append(leaf(v))
                    continue
                if v not in env:
                    assert v in s.live_in
                    at = gen.slots[v]
                    env[v] = (st[at] if width[v] == 1
                              else st[at:at + 3]).clone()
                args.append(env[v])
            op, dst = code[i][0], code[i][1]
            if op == aircomp.BB_ADD:
                y = gf.add(*args)
            elif op == aircomp.BB_MUL:
                y = gf.mul(*args)
            elif op == aircomp.BX_ADD:
                y = torch.stack([gf.add(args[0][0], args[1]), args[0][1],
                                 args[0][2]])
            elif op == aircomp.BX_MUL:
                y = gfx.bfe_mul(*args)
            elif op == aircomp.XX_ADD:
                y = gfx.add(*args)
            elif op == aircomp.XX_MUL:
                y = gfx.mul(*args)
            elif op == aircomp.FOLD_B:
                acc = gfx.add(acc, gfx.bfe_mul(ws[:, dst, None], args[0]))
                continue
            elif op == aircomp.FOLD_X:
                acc = gfx.add(acc, gfx.mul(ws[:, dst, None], args[0]))
                continue
            else:
                st[T:T + 3] = gfx.add(st[T:T + 3], gfx.bfe_mul(
                    acc, st[tape_codegen.ZEROFIERS + dst]))
                acc = torch.zeros_like(acc)
                continue
            env[i] = y
            if i in s.live_out:
                at = gen.slots[i]
                st[at:at + width[i]] = y
        st[A:A + 3] = acc
    return st[T:T + 3]


@pytest.mark.parametrize("target", [150, tape_codegen.SEGMENT_INSTRUCTIONS])
def test_reenacted_schedule_matches_plain(tape, inputs, want, target):
    assert torch.equal(_reenact(tape, inputs, target), want)


# Host stand-ins of csrc/quotient.cu's helpers for the generated body.
_HOST_HELPERS = r"""
#include <cstdint>
#define __device__
#define __noinline__ __attribute__((noinline))
#define __restrict__ __restrict
#define QUOTIENT_SEGMENT(name) \
  void name(const Row* r, uint64_t* st, int64_t stride)
#define QUOTIENT_ROW_SETUP() (void)0
#define S(w) st[(int64_t)(w) * stride]
#define LDX(w) (Xfe{{S(w), S((w) + 1), S((w) + 2)}})
#define STX(w, v) \
  do { const Xfe v_ = (v); S(w) = v_.c[0]; S((w) + 1) = v_.c[1]; \
       S((w) + 2) = v_.c[2]; } while (0)
typedef unsigned __int128 u128;
static const uint64_t P = 0xFFFFFFFF00000001ull;
static uint64_t fadd(uint64_t a, uint64_t b) { return (uint64_t)(((u128)a + b) % P); }
static uint64_t fsub(uint64_t a, uint64_t b) { return (uint64_t)(((u128)a + P - b) % P); }
static uint64_t fmul(uint64_t a, uint64_t b) { return (uint64_t)(((u128)a * b) % P); }
struct Xfe { uint64_t c[3]; };
static Xfe xadd(const Xfe& a, const Xfe& b) {
  return {{fadd(a.c[0], b.c[0]), fadd(a.c[1], b.c[1]), fadd(a.c[2], b.c[2])}};
}
static Xfe xmul(const Xfe& a, const Xfe& b) {
  uint64_t d0 = fmul(a.c[0], b.c[0]);
  uint64_t d1 = fadd(fmul(a.c[0], b.c[1]), fmul(a.c[1], b.c[0]));
  uint64_t d2 = fadd(fadd(fmul(a.c[0], b.c[2]), fmul(a.c[1], b.c[1])),
                     fmul(a.c[2], b.c[0]));
  uint64_t d3 = fadd(fmul(a.c[1], b.c[2]), fmul(a.c[2], b.c[1]));
  uint64_t d4 = fmul(a.c[2], b.c[2]);
  return {{fsub(d0, d3), fadd(d1, fsub(d3, d4)), fadd(d2, d4)}};
}
static Xfe xscale(const Xfe& a, uint64_t s) {
  return {{fmul(a.c[0], s), fmul(a.c[1], s), fmul(a.c[2], s)}};
}
static uint64_t fneg(uint64_t a) { return fsub(0, a); }
static Xfe xneg(const Xfe& a) { return {{fneg(a.c[0]), fneg(a.c[1]), fneg(a.c[2])}}; }
static Xfe bxadd(const Xfe& a, uint64_t b) { return {{fadd(a.c[0], b), a.c[1], a.c[2]}}; }
struct Row {
  const uint64_t* main; const uint64_t* next_main; int64_t ms0;
  const uint64_t* aux; const uint64_t* next_aux; int64_t as0, as1;
  const uint64_t* ch; int64_t nch; const uint64_t* w; int64_t nw;
};
static uint64_t in_main(const Row* r, int c) { return r->main[c * r->ms0]; }
static uint64_t in_next_main(const Row* r, int c) { return r->next_main[c * r->ms0]; }
static Xfe in_aux(const Row* r, int c) {
  const uint64_t* p = r->aux + c * r->as1;
  return {{p[0], p[r->as0], p[2 * r->as0]}};
}
static Xfe in_next_aux(const Row* r, int c) {
  const uint64_t* p = r->next_aux + c * r->as1;
  return {{p[0], p[r->as0], p[2 * r->as0]}};
}
static Xfe challenge(const Row* r, int c) {
  return {{r->ch[c], r->ch[r->nch + c], r->ch[2 * r->nch + c]}};
}
static Xfe weight(const Row* r, int k) {
  return {{r->w[k], r->w[r->nw + k], r->w[2 * r->nw + k]}};
}
"""

# rows 0 .. n - 1 through the segments in order (row_body, written by the
# test), each row's state words one after another (stride 1), the
# zerofier inverses given (4, n), the totals written (3, n)
_HOST_MAIN = r"""
extern "C" void run_rows(const uint64_t* main, int64_t ms0, int64_t ms1,
                         const uint64_t* aux, int64_t as0, int64_t as1,
                         int64_t as2, const uint64_t* ch, int64_t nch,
                         const uint64_t* w, int64_t nw, const uint64_t* zi,
                         int64_t n, int64_t m, int64_t shift, uint64_t* out,
                         int64_t state_words) {
  uint64_t* st = new uint64_t[state_words];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t ni = (i + shift) % m;
    const Row r{main + i * ms1, main + ni * ms1, ms0, aux + i * as2,
                aux + ni * as2, as0, as1, ch, nch, w, nw};
    for (int64_t k = 0; k < state_words; ++k) st[k] = 0x5555AAAA5555AAAAull;
    for (int c = 0; c < 6; ++c) st[c] = 0;
    for (int p = 0; p < 4; ++p) st[6 + p] = zi[p * n + i];
    row_body(&r, st);
    for (int c = 0; c < 3; ++c) out[c * n + i] = st[3 + c];
  }
  delete[] st;
}
"""


def test_generated_body_compiled_on_the_host_matches_plain(tape, inputs,
                                                           want, tmp_path):
    """The generated segments, compiled with g++ (-O0: about 2 s) over
    host versions of csrc/quotient.cu's helpers and frame (each segment
    kernel a function of one row), run in order on the same rows through
    their strides (aux permuted, the halo's shift)."""
    cxx = shutil.which("g++")
    assert cxx, "the host's C++ compiler (g++) is needed"
    gen = tape_codegen.generate(tape)
    row_body = ("static void row_body(const Row* r, uint64_t* st) {\n"
                + "".join(f"  seg_{k}(r, st, 1);\n"
                          for k in range(len(gen.functions))) + "}\n")
    src = tmp_path / "rows.cc"
    src.write_text(_HOST_HELPERS + "\n\n".join(gen.functions) + "\n"
                   + row_body + _HOST_MAIN)
    so = tmp_path / "librows.so"
    subprocess.run([cxx, "-O0", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    main, aux, ch, ws = inputs["main"], inputs["aux"], inputs["ch"], \
        inputs["ws"]
    N, M = inputs["points"].n, main.shape[1]
    zi = quotient_cuda.zerofier_inverses(
        inputs["points"].tensor("cpu"), inputs["trace_len"],
        inputs["gen_inv"]).contiguous()
    out = torch.empty((3, N), dtype=torch.int64)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.run_rows.argtypes = [vp, i64, i64, vp, i64, i64, i64, vp, i64, vp,
                             i64, vp, i64, i64, i64, vp, i64]
    lib.run_rows(main.data_ptr(), *main.stride(), aux.data_ptr(),
                 *aux.stride(), ch.data_ptr(), ch.shape[1], ws.data_ptr(),
                 ws.shape[1], zi.data_ptr(), N, M, inputs["shift"],
                 out.data_ptr(), gen.state_words)
    assert torch.equal(out, want)
