"""K4, the port's NTT kernel (csrc/ntt.cu, ops/ntt_cuda.py), on the CPU.

The kernel itself runs only on a card. What it computes is fixed on the
host: the split of each length into passes (`ntt_cuda.plan`), the tables
the passes read (`ntt_cuda.tables`) and the scales ops/ntt.py fuses into
them. `reenact` runs those passes in torch as the kernel runs them (the
strided sub-sequences, the zero-padding and scales on the load and the
store, the pass-2 twiddle from its two 2^12-word tables, bit-reversed
order and the decimation-in-time stages over the inner twiddles), and the
result is held word for word against the JAX package's ntt / intt / lde
(triton_vm_tpu.ops.ntt, run on the CPU as tests/test_torch_ntt.py runs
it). The dispatcher's CPU path and K4's refusals are checked here; the
kernel against its plain version on the card is in
tests/test_torch_cuda.py (marked `cuda`, it imports no JAX)."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import ntt as jntt
from triton_vm_tpu_torch.fields import bfe
from triton_vm_tpu_torch.ops import gf, ntt, ntt_cuda

torch.set_num_threads(2)

RANDOM_OFFSET = int(np.random.default_rng(12).integers(2, P,
                                                       dtype=np.uint64))


def _field(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    edge = [0, 1, P - 1, 2**32, 2**63, P - 2**32, 2**32 - 1, P - 2]
    a.reshape(-1)[:len(edge)] = edge[:a.size]
    return a


def reenact(x, root: int, length: int, pre=None, post=None):
    """K4's passes over the rows of x (rows, n_in), in torch on the CPU:
    out[r, k] = post[k] sum_i pre[i] x[r, i] root^(i k)."""
    rows, n_in = x.shape
    tw, inner = ntt_cuda.tables(length, root)
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
        if p.first and pre is not None:
            v = gf.mul(v, pre[at])
        if p.twiddle:
            e = s * j
            lo, hi = (gf.from_u64(t) for t in tw)
            v = gf.mul(v, gf.mul(lo[e & ((1 << ntt_cuda.TW_BITS) - 1)],
                                 hi[e >> ntt_cuda.TW_BITS]))
        v = v[..., torch.as_tensor(ntt.bitrev_indices(n_len))]
        w_all = gf.from_u64(inner[k])
        for lm in range(p.log_len):
            m = 1 << lm
            vv = v.reshape(rows, seqs, n_len // (2 * m), 2, m)
            u, t = vv[..., 0, :], vv[..., 1, :]
            t = gf.mul(t, w_all[torch.arange(m) << (p.log_len - 1 - lm)])
            v = torch.stack([gf.add(u, t), gf.sub(u, t)], dim=-2).reshape(
                rows, seqs, n_len)
        opos = s * p.out_seq + j * p.out_elem
        if p.last and post is not None:
            v = gf.mul(v, post[opos])
        out = out.clone()
        out[:, opos.reshape(-1)] = v.reshape(rows, -1)
    return out


def _ntt_k4(a, offset, length=None):
    """ntt.ntt's K4 call, re-enacted: (..., n) -> (..., length)."""
    x = gf.from_u64(a.reshape(-1, a.shape[-1]))
    n = x.shape[-1]
    length = length or n
    got = reenact(x, bfe.primitive_root_of_unity(length), length,
                  ntt._coset_scale(n, offset, "cpu"))
    return gf.to_u64(got).reshape(a.shape[:-1] + (length,))


def _intt_k4(a, offset):
    x = gf.from_u64(a.reshape(-1, a.shape[-1]))
    n = x.shape[-1]
    got = reenact(x, bfe.inv(bfe.primitive_root_of_unity(n)), n,
                  post=ntt._unscale(n, offset, "cpu"))
    return gf.to_u64(got).reshape(a.shape)


def _jax(fn, a, *args):
    return jgf.to_u64(fn(jgf.from_u64(a), *args))


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("log_n", range(0, ntt_cuda.MAX_LOG_LENGTH + 1))
def test_plan_covers_every_length(log_n):
    """Each pass fits a CTA's shared memory; the passes' lengths multiply
    to n; a four-step split's pass 1 reads every input position once and
    pass 2 writes every output position once."""
    n = 1 << log_n
    passes = ntt_cuda.plan(n)
    assert sum(p.log_len for p in passes) == log_n
    for p in passes:
        assert p.log_len <= ntt_cuda.MAX_PASS_LOG
        assert p.log_len + p.log_tile <= ntt_cuda.MAX_LOG_TILE_WORDS
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
    """w^e = lo[e mod 2^12] * hi[e >> 12] for every e < n at 2^24."""
    n = 1 << 24
    root = bfe.primitive_root_of_unity(n)
    (lo, hi), inner = ntt_cuda.tables(n, root)
    assert lo.shape == hi.shape == (1 << 12,)
    for e in (0, 1, 4095, 4096, 123456789 % n, n - 1):
        assert int(lo[e % 4096]) * int(hi[e >> 12]) % P == pow(root, e, P)
    for p, w in zip(ntt_cuda.plan(n), inner):
        w_len = pow(root, n >> p.log_len, P)
        assert len(w) == 1 << (p.log_len - 1)
        assert int(w[1]) == w_len and pow(w_len, 1 << p.log_len, P) == 1


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
