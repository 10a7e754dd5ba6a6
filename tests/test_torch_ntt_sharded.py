"""The port's six-step transform (ops/ntt_sharded.py) against the JAX
package's on the conftest's virtual CPU devices, and against the port's
own single-device NTT: equal element for element. Also the transform's
round trip, its refusal of a length the mesh cannot split, the
TVM_INTRA_NTT_MIN selection of `xfe_*_auto`, and STIR's transcript with
the six-step transform in its rounds."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import ntt_sharded as jns
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf, ntt, ntt_sharded
from triton_vm_tpu_torch.parallel import sharding

torch.set_num_threads(2)


def _jax_mesh(d):
    import jax
    from jax.sharding import Mesh

    from triton_vm_tpu.parallel.sharding import AXIS

    devices = jax.devices()
    if len(devices) < d:
        pytest.skip(f"needs {d} (virtual) devices")
    return Mesh(np.array(devices[:d]), (AXIS,))


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("offset", [1, 7])
@pytest.mark.parametrize("log_n", [6, 12])
def test_sharded_transform_matches_jax_and_single_device(log_n, offset, d,
                                                          inverse):
    x = _field(log_n * 100 + d * 10 + offset, 1 << log_n)
    mesh = sharding.place(d, "cpu")
    port_fn, jax_fn, single = (
        (ntt_sharded.intt_sharded, jns.intt_sharded, ntt.intt) if inverse
        else (ntt_sharded.ntt_sharded, jns.ntt_sharded, ntt.ntt))
    got = port_fn(gf.from_u64(x), mesh, offset)
    assert len(got.parts) == d
    got = gf.to_u64(sharding.gather(got, "cpu"))
    want = jgf.to_u64(jax_fn(jgf.from_u64(x), _jax_mesh(d), offset))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, gf.to_u64(single(gf.from_u64(x), offset)))


def test_roundtrip_xfe_column():
    """An XFE column (3, 2^14) forward and back over 8 shards, one pass
    for all 3 coefficients."""
    x = gf.from_u64(_field(14, (3, 1 << 14)))
    mesh = sharding.place(8, "cpu")
    vals = sharding.gather(ntt_sharded.ntt_sharded(x, mesh, 7), "cpu")
    assert torch.equal(vals, ntt.ntt(x, 7))
    back = sharding.gather(ntt_sharded.intt_sharded(vals, mesh, 7), "cpu")
    assert torch.equal(back, x)


@pytest.mark.parametrize("n,d", [(8, 4), (32, 8), (64, 16)])
def test_length_the_mesh_cannot_split_raises(n, d):
    with pytest.raises(ValueError, match="not divisible|does not divide"):
        ntt_sharded.ntt_sharded(torch.zeros(n, dtype=torch.int64),
                                sharding.place(d, "cpu"))


@pytest.mark.parametrize("mesh_env,threshold,n,sharded", [
    (None, "64", 1 << 10, False),       # no mesh
    ("4", None, 1 << 12, False),        # below the default 2^18
    ("4", "64", 1 << 10, True),
    ("8", "64", 1 << 10, True),
    ("8", "64", 32, False),             # below the threshold
    ("8", "16", 32, False),             # 32 % 8^2 != 0
])
def test_auto_selects_the_mesh_by_length(monkeypatch, mesh_env, threshold,
                                         n, sharded):
    for key, value in (("TVM_MESH", mesh_env),
                       ("TVM_INTRA_NTT_MIN", threshold)):
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    x = gf.from_u64(_field(n, (3, n)))
    ntt_sharded.reset_launch_counts()
    vals = ntt_sharded.xfe_ntt_auto(x, 7)
    coeffs = ntt_sharded.xfe_intt_auto(vals, 7)
    assert ntt_sharded.launches["ntt_sharded"] == (2 if sharded else 0)
    assert torch.equal(vals, ntt.ntt(x, 7))
    assert torch.equal(coeffs, x)


def test_stir_transcript_with_intra_column_sharding(monkeypatch):
    """STIR's prover with the six-step transform in its initial iNTT and
    in every round's three transforms (onto the next domain, onto the
    folded domain for the queried points, and the quotient's iNTT;
    TVM_MESH=8, TVM_INTRA_NTT_MIN=64) emits the transcript of the
    single-device prover: the counterpart of the JAX package's
    test_stir_device_prove_with_intra_column_sharding."""
    from triton_vm_tpu_torch.ldt.stir import Stir, StirParameters
    from triton_vm_tpu_torch.ops import gfx
    from triton_vm_tpu_torch.stark.proof_stream import ProofStream

    params = StirParameters(security_level=20, log2_folding_factor=2,
                            log2_initial_expansion_factor=2,
                            log2_high_degree_bound=11)
    stir = Stir(params)
    assert len(stir.round_queries) == 2
    coeffs = np.zeros((stir.domain.length, 3), np.uint64)
    coeffs[:params.max_degree() + 1] = _field(
        11, (params.max_degree() + 1, 3))
    codeword = ntt.ntt(gfx.from_u64(coeffs), stir.domain.offset)
    transcripts = []
    for mesh_env in (None, "8"):
        if mesh_env is None:
            monkeypatch.delenv("TVM_MESH", raising=False)
        else:
            monkeypatch.setenv("TVM_MESH", mesh_env)
            monkeypatch.setenv("TVM_INTRA_NTT_MIN", "64")
        ntt_sharded.reset_launch_counts()
        ps = ProofStream()
        indices = stir.prove(codeword, ps)
        transcripts.append((indices, ps.to_proof().words,
                            ntt_sharded.launches["ntt_sharded"]))
    (i0, w0, n0), (i1, w1, n1) = transcripts
    assert n0 == 0 and n1 == 1 + 3 * len(stir.round_queries)
    assert i1 == i0 and w1 == w0
