"""K4, the port's NTT kernel (csrc/ntt.cu, ops/ntt_cuda.py), on the CPU.

The kernel itself runs only on a card. What it computes is fixed on the
host: the split of each length into passes (`ntt_cuda.plan`) and of each
pass into levels of radix up to 16, the tables the passes read
(`ntt_cuda.tables`) and the scales ops/ntt.py fuses into them, read from
the two 2^12-word tables of `gf.power_tables`. `reenact` runs those
passes in torch as the kernel runs them (the strided sub-sequences, the
zero-padding and scales on the load and the store, the pass-2 twiddle
from its two tables; each level's groups gathered in bit-reversed order,
the radix-2 stages over the register roots, the levels' twiddles from
their k-major table, the last level's outputs at their digit-reversed
positions), and the result is held word for word against the JAX
package's ntt / intt / lde (triton_vm_tpu.ops.ntt, run on the CPU as
tests/test_torch_ntt.py runs it). The dispatcher's CPU path and K4's
refusals are checked here; the kernel against its plain version on the
card is in tests/test_torch_cuda.py (marked `cuda`, it imports no JAX)."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import ntt as jntt
from triton_vm_tpu_torch.fields import bfe
from triton_vm_tpu_torch.ops import gf, npfield, ntt, ntt_cuda

torch.set_num_threads(2)

RANDOM_OFFSET = int(np.random.default_rng(12).integers(2, P,
                                                       dtype=np.uint64))


def _field(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    edge = [0, 1, P - 1, 2**32, 2**63, P - 2**32, 2**32 - 1, P - 2]
    a.reshape(-1)[:len(edge)] = edge[:a.size]
    return a


def _table_power(tables, e):
    """csrc/goldilocks.cuh's table_power: lo[e mod 2^12] * hi[e >> 12]."""
    lo, hi = tables
    return gf.mul(lo[e & ((1 << gf.POW_BITS) - 1)], hi[e >> gf.POW_BITS])


def _bitrev(bits):
    return torch.as_tensor(ntt.bitrev_indices(1 << bits))


def _registers_dft(a, roots, r):
    """csrc/ntt.cu's dft over the last axis of a (..., 2^r), bit-reversed
    in, natural order out: the stage of half-width h multiplies by
    roots[j * 8 / h]."""
    R = 1 << r
    h = 1
    while h < R:
        v = a.reshape(*a.shape[:-1], R // (2 * h), 2, h)
        u = v[..., 0, :]
        w = gf.mul(v[..., 1, :], roots[torch.arange(h) * (8 // h)])
        a = torch.stack([gf.add(u, w), gf.sub(u, w)], dim=-2).reshape(
            a.shape)
        h *= 2
    return a


def _levels(v, p, inner, roots):
    """A pass's levels over v (rows, seqs, L), natural order in and out."""
    rows, seqs, L = v.shape
    lv, log_m, off = p.levels, p.log_len, 0
    for k, r in enumerate(lv):
        R, Q = 1 << r, 1 << (log_m - r)
        # group (seg, i_a) holds the words at seg M + i_a + Q b, b < R
        g = v.reshape(rows, seqs, L >> log_m, R, Q).transpose(-1, -2)
        g = _registers_dft(g[..., _bitrev(r)], roots, r)
        if k < len(lv) - 1:
            tw = inner[off + torch.arange(R)[None, :] * Q
                       + torch.arange(Q)[:, None]]        # (Q, R)
            g = gf.mul(g, tw)
            v = g.transpose(-1, -2).reshape(rows, seqs, L)
            off += 1 << log_m
            log_m -= r
            continue
        # the last level: segment seg's output k is X[xb(seg) + (L / R) k]
        seg = torch.arange(L >> r)
        if len(lv) == 3:
            xb = (seg >> lv[1]) + ((seg & ((1 << lv[1]) - 1)) << lv[0])
        else:
            xb = seg
        x = torch.empty_like(v)
        x[..., xb[:, None] + (L >> r) * torch.arange(R)[None, :]] = \
            g.reshape(rows, seqs, L >> r, R)
        return x
    return v


def reenact(x, root: int, length: int, pre=None, post=None):
    """K4's passes over the rows of x (rows, n_in), in torch on the CPU:
    out[r, k] = post(k) sum_i pre(i) x[r, i] root^(i k), a scale (base,
    factor) being i -> factor * base^i."""
    rows, n_in = x.shape
    tw, inner, roots = ntt_cuda.tables(length, root)
    pre_t = None if pre is None else gf.power_tables(*pre)
    post_t = None if post is None else gf.power_tables(*post)
    out = torch.zeros((rows, length), dtype=torch.int64)
    for k, p in enumerate(ntt_cuda.plan(length)):
        n_len, seqs = 1 << p.log_len, 1 << p.log_seqs
        src, src_n = (x, n_in) if p.first else (out, length)
        s = torch.arange(seqs)[:, None]
        j = torch.arange(n_len)[None, :]
        pos = s * p.in_seq + j * p.in_elem                  # (seqs, L)
        valid = pos < src_n
        at = pos.clamp(max=src_n - 1)
        v = torch.where(valid, src[:, at], 0)               # (rows, seqs, L)
        if p.first and pre_t is not None:
            v = gf.mul(v, _table_power(pre_t, at))
        if p.twiddle:
            v = gf.mul(v, _table_power([gf.from_u64(t) for t in tw], s * j))
        v = _levels(v, p, gf.from_u64(inner[k]), gf.from_u64(roots[k]))
        opos = s * p.out_seq + j * p.out_elem
        if p.last and post_t is not None:
            v = gf.mul(v, _table_power(post_t, opos))
        out = out.clone()
        out[:, opos.reshape(-1)] = v.reshape(rows, -1)
    return out


def _ntt_k4(a, offset, length=None):
    """ntt.ntt's K4 call, re-enacted: (..., n) -> (..., length)."""
    x = gf.from_u64(a.reshape(-1, a.shape[-1]))
    n = x.shape[-1]
    length = length or n
    got = reenact(x, bfe.primitive_root_of_unity(length), length,
                  ntt._coset_scale(offset))
    return gf.to_u64(got).reshape(a.shape[:-1] + (length,))


def _intt_k4(a, offset):
    x = gf.from_u64(a.reshape(-1, a.shape[-1]))
    n = x.shape[-1]
    got = reenact(x, bfe.inv(bfe.primitive_root_of_unity(n)), n,
                  post=ntt._unscale(n, offset))
    return gf.to_u64(got).reshape(a.shape)


def _jax(fn, a, *args):
    return jgf.to_u64(fn(jgf.from_u64(a), *args))


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("log_n", range(0, ntt_cuda.MAX_LOG_LENGTH + 1))
def test_plan_covers_every_length(log_n):
    """Each pass fits a CTA (16 words a thread, at most 512 threads); its
    levels' radix bits sum to its length's, each at most 4, every level
    but the last of radix 16 when there are several; the passes' lengths
    multiply to n; a four-step split's pass 1 reads every input position
    once and pass 2 writes every output position once."""
    n = 1 << log_n
    passes = ntt_cuda.plan(n)
    assert sum(p.log_len for p in passes) == log_n
    for p in passes:
        assert p.log_len <= ntt_cuda.MAX_PASS_LOG
        assert 1 <= ntt_cuda.threads(p) <= ntt_cuda.MAX_THREADS
        assert sum(p.levels) == p.log_len and max(p.levels) <= 4
        assert len(p.levels) == 1 or p.levels[0] == 4 == p.levels[-1] or (
            len(p.levels) == 2 and p.levels[0] == 4)
    assert passes[0].first and passes[-1].last
    assert len(passes) == (1 if log_n <= ntt_cuda.MAX_PASS_LOG else 2)
    if len(passes) == 2 and log_n <= 16:
        for p, seq, elem in ((passes[0], "in_seq", "in_elem"),
                             (passes[0], "out_seq", "out_elem"),
                             (passes[1], "in_seq", "in_elem")):
            s = np.arange(1 << p.log_seqs)[:, None]
            j = np.arange(1 << p.log_len)[None, :]
            pos = s * getattr(p, seq) + j * getattr(p, elem)
            assert np.array_equal(np.sort(pos.ravel()), np.arange(n))


def test_plan_refuses_what_the_kernel_cannot_take():
    for bad in (0, 3, 96, 1 << 25):
        with pytest.raises(ValueError, match="power of two"):
            ntt_cuda.plan(bad)


# ------------------------------------------------------------ re-enacted

@pytest.mark.parametrize("log_n", range(1, 15))
def test_reenacted_coset_ntt_matches_jax(log_n):
    n = 1 << log_n
    a = _field(log_n, (3, n))
    assert np.array_equal(_ntt_k4(a, 7), _jax(jntt.ntt, a, 7))


@pytest.mark.parametrize("log_n", range(1, 15))
def test_reenacted_intt_matches_jax(log_n):
    n = 1 << log_n
    a = _field(100 + log_n, (2, n))
    assert np.array_equal(_intt_k4(a, RANDOM_OFFSET),
                          _jax(jntt.intt, a, RANDOM_OFFSET))


@pytest.mark.parametrize("offset", [1, 7, RANDOM_OFFSET])
@pytest.mark.parametrize("log_n", [3, 12, 13])
def test_reenacted_offsets_match_jax(log_n, offset):
    a = _field(offset % 1000 + log_n, (4, 1 << log_n))
    assert np.array_equal(_ntt_k4(a, offset), _jax(jntt.ntt, a, offset))
    assert np.array_equal(_intt_k4(a, offset), _jax(jntt.intt, a, offset))


@pytest.mark.parametrize("n,length", [(1, 2), (3, 8), (100, 128),
                                      (1000, 4096), (2049, 1 << 13),
                                      (5000, 1 << 14)])
def test_reenacted_padding_matches_jax(n, length):
    """length > n: the coefficients zero-padded on K4's load."""
    a = _field(n, (3, n))
    padded = np.zeros((3, length), np.uint64)
    padded[:, :n] = a
    assert np.array_equal(_ntt_k4(a, 7, length), _jax(jntt.ntt, padded, 7))


@pytest.mark.parametrize("n,expansion", [(16, 4), (2048, 4), (4096, 2)])
def test_reenacted_lde_matches_jax(n, expansion):
    """lde: K4's iNTT (its store scaled) then its coset NTT (zero-padded,
    its load scaled), as ops/ntt.py launches them."""
    a = _field(n + expansion, (2, n))
    got = _ntt_k4(_intt_k4(a, 1), 7, n * expansion)
    assert np.array_equal(got, _jax(jntt.lde, a, expansion, 1, 7))


@pytest.mark.parametrize("shape", [(3, 1 << 13), (4, 3, 1 << 9)])
def test_reenacted_xfe_batches_match_jax(shape):
    """XFE columns (3, n) and (nc, 3, n): every leading axis is a row."""
    a = _field(sum(shape), shape)
    assert np.array_equal(_ntt_k4(a, 7), _jax(jntt.ntt, a, 7))
    assert np.array_equal(_intt_k4(a, 7), _jax(jntt.intt, a, 7))


def test_twiddle_tables_split_the_exponent():
    """w^e = lo[e mod 2^12] * hi[e >> 12] for every e < n at 2^24; each
    pass's register roots are the powers of a primitive 16th root, and
    its levels' twiddle (k, i_a) is w_M^(i_a k), k-major."""
    n = 1 << 24
    root = bfe.primitive_root_of_unity(n)
    (lo, hi), inner, roots = ntt_cuda.tables(n, root)
    assert lo.shape == hi.shape == (1 << 12,)
    for e in (0, 1, 4095, 4096, 123456789 % n, n - 1):
        assert int(lo[e % 4096]) * int(hi[e >> 12]) % P == pow(root, e, P)
    for p, w, rw in zip(ntt_cuda.plan(n), inner, roots):
        w_len = pow(root, n >> p.log_len, P)
        w16 = int(rw[1])
        assert w16 == pow(w_len, (1 << p.log_len) // 16, P)
        assert pow(w16, 8, P) == P - 1
        assert [int(v) for v in rw] == [pow(w16, j, P) for j in range(8)]
        assert p.levels == (4, 4, 4) and len(w) == 4096 + 256
        for k, ia in ((1, 1), (3, 200), (15, 255)):
            assert int(w[k * 256 + ia]) == pow(w_len, ia * k, P)
        w_256 = pow(w_len, 16, P)
        for k, ia in ((1, 1), (7, 9), (15, 15)):
            assert int(w[4096 + k * 16 + ia]) == pow(w_256, ia * k, P)


def test_work_counts_the_bound():
    """A main-table JIT coset at 2^20: 379 x 2^21 words with the coset
    scale, 2^20 * 21 + 2^21 products a column, 8 int32 multiplies each."""
    b, ops = ntt_cuda.work(379, 1 << 21, 1 << 21, scaled_words=1 << 21)
    assert b == 8 * 379 * 2 * (1 << 21)
    assert ops == 8 * 379 * ((1 << 20) * 21 + (1 << 21))


# ------------------------------------------------------------ dispatch

def test_cpu_tensors_take_the_plain_network(monkeypatch):
    calls = []
    plain = ntt._transform_plain

    def spy(x, root):
        calls.append(tuple(x.shape))
        return plain(x, root)

    def refuse(*args, **kwargs):
        raise AssertionError("K4 was called with a CPU tensor")

    monkeypatch.setattr(ntt, "_transform_plain", spy)
    monkeypatch.setattr(ntt_cuda, "ntt_rows", refuse)
    a = _field(5, (3, 64))
    x = gf.from_u64(a)
    assert np.array_equal(gf.to_u64(ntt.ntt(x, 7)), _jax(jntt.ntt, a, 7))
    assert np.array_equal(gf.to_u64(ntt.intt(x, 7)), _jax(jntt.intt, a, 7))
    assert np.array_equal(gf.to_u64(ntt.lde(x, 2, 1, 7)),
                          _jax(jntt.lde, a, 2, 1, 7))
    root = bfe.primitive_root_of_unity(64)
    assert np.array_equal(gf.to_u64(ntt._transform(x, root)),
                          _jax(jntt.ntt, a, 1))
    assert calls == [(3, 64), (3, 64), (3, 64), (3, 128), (3, 64)]


def test_k4_refuses_what_it_cannot_take():
    x = torch.zeros((4, 64), dtype=torch.int64)
    root = bfe.primitive_root_of_unity(64)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.ntt_rows(x, root, 64)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda.ntt_rows(x, root, 96)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_rows(torch.zeros((64, 4), dtype=torch.int64).T, root,
                          64)
    with pytest.raises(ValueError, match="pad"):
        ntt_cuda.ntt_rows(x, bfe.primitive_root_of_unity(32), 32)
    with pytest.raises(TypeError, match="int64"):
        ntt_cuda.ntt_rows(x.float(), root, 64)


# ------------------------------------------------------------ power tables

@pytest.mark.parametrize("offset", [0, P - 1, RANDOM_OFFSET])
@pytest.mark.parametrize("n", [1, (1 << 12) - 1, 1 << 12, (1 << 12) + 1,
                               1 << 20])
def test_two_table_powers_equal_the_host_ladder(n, offset):
    """gf.table_powers, the route gf.powers takes on a card (two 2^12-word
    tables gathered and multiplied once), equals npfield.powers_u64 word
    for word, offsets 0 and p - 1 included; and it builds no host table
    longer than 2^12 words."""
    base = bfe.primitive_root_of_unity(1 << 21)
    before = npfield.long_tables["powers_u64"]
    got = gf.to_u64(gf.table_powers(base, n, offset, "cpu"))
    assert npfield.long_tables["powers_u64"] == before
    assert np.array_equal(got, npfield.powers_u64(base, offset, n))


def test_power_tables_split_the_exponent():
    lo, hi = gf.power_tables(7, 5)
    for e in (0, 1, 4095, 4096, 123456, (1 << 24) - 1):
        assert (int(gf.to_u64(lo)[e % 4096]) * int(gf.to_u64(hi)[e >> 12])
                % P == 5 * pow(7, e, P) % P)
    with pytest.raises(ValueError, match="exceed"):
        gf.table_powers(7, (1 << 24) + 1, 1, "cpu")
