"""The port's sharded prover primitives (parallel/mesh.py,
parallel/sharding.py) on CPU meshes: the sharded LDE, row hash and Merkle
root against the JAX package's `parallel/mesh.py` on its 8-device virtual
mesh; padded column counts against the unpadded single-device digests;
TVM_MESH parsing and shard placement; the quotient halo at the wrap; and
the row-sharded quotients against the single-device quotients. Exact
equality throughout."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu_torch.crypto import merkle
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf, tip5_kernel
from triton_vm_tpu_torch.parallel import mesh as pm
from triton_vm_tpu_torch.parallel import sharding

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_mesh8():
    import jax

    from triton_vm_tpu.parallel import mesh as jpm

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jpm, jpm.default_mesh(8)


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _root(heap):
    return tuple(int(x) for x in gf.to_u64(heap[:, 0]))


def test_sharded_lde_matches_jax(jax_mesh8):
    jpm, jmesh = jax_mesh8
    cols = _field(0, (16, 64))
    want = np.asarray(jgf.to_u64(jpm.sharded_lde(jmesh, jgf.from_u64(cols),
                                                  4, 1, 7)))
    got = pm.sharded_lde(sharding.place(8, "cpu"), gf.from_u64(cols), 4, 1, 7)
    assert len(got.parts) == 8 and got.parts[0].shape == (2, 256)
    assert np.array_equal(gf.to_u64(sharding.gather(got, "cpu")), want)


def test_sharded_row_hash_and_merkle_root_match_jax(jax_mesh8):
    jpm, jmesh = jax_mesh8
    cols = _field(1, (16, 32))
    jlde = jpm.sharded_lde(jmesh, jgf.from_u64(cols), 2)
    jdigests = jpm.sharded_row_hash(jmesh, jlde)
    jroot = tuple(int(x) for x in np.asarray(jgf.to_u64(
        jpm.sharded_merkle_layers(jmesh, jdigests)[-1]))[:, 0])

    mesh = sharding.place(8, "cpu")
    digests = pm.sharded_row_hash(mesh, pm.sharded_lde(mesh,
                                                       gf.from_u64(cols), 2))
    assert [p.shape for p in digests.parts] == [(5, 8)] * 8
    assert np.array_equal(gf.to_u64(sharding.gather(digests, "cpu")),
                          np.asarray(jgf.to_u64(jdigests)))
    heap = pm.sharded_merkle_layers(mesh, digests)
    assert _root(heap) == jroot


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("width", [379, 91], ids=["main", "aux"])
def test_padded_columns_never_reach_a_digest(width, d):
    """379 main and 91 aux columns do not divide 4 or 8: the pad columns
    are dropped before the exchange, so every leaf digest and the whole
    Merkle heap equal the single-device ones. The aux table is sharded by
    XFE column (NA, 3, L) and hashed in the committed row order."""
    L = 64
    shape = (width, L) if width == 379 else (width, 3, L)
    table = gf.from_u64(_field(width, shape))
    mesh = sharding.place(d, "cpu")
    sharded = pm.shard_columns(mesh, table)
    assert sharded.parts[0].shape[0] * d > width and sharded.size == width
    assert torch.equal(sharding.gather(sharded, "cpu"), table)
    rows = sharded.unpadded().map(lambda p: p.reshape(-1, L), axis=0)
    digests = pm.sharded_row_hash(mesh, rows)
    want = tip5_kernel.sponge_absorb_rows(table.reshape(-1, L).T)
    assert torch.equal(sharding.gather(digests, "cpu"), want)
    assert torch.equal(pm.sharded_merkle_layers(mesh, digests),
                       tip5_kernel.merkle_flat(want))


@pytest.mark.parametrize("value,size", [(None, None), ("", None),
                                        ("0", None), ("1", None),
                                        ("2", 2), ("4", 4), ("8", 8)])
def test_active_mesh_parsing(monkeypatch, value, size):
    if value is None:
        monkeypatch.delenv("TVM_MESH", raising=False)
    else:
        monkeypatch.setenv("TVM_MESH", value)
    mesh = sharding.active_mesh("cpu")
    if size is None:
        assert mesh is None
    else:
        assert mesh.devices == (torch.device("cpu"),) * size
        assert mesh.lead == torch.device("cpu")


@pytest.mark.parametrize("value", ["3", "6", "12"])
def test_mesh_size_not_a_power_of_two_raises(monkeypatch, value):
    monkeypatch.setenv("TVM_MESH", value)
    with pytest.raises(ValueError, match="power-of-two"):
        sharding.active_mesh("cpu")


def test_cuda_shards_wrap_over_the_visible_cards(monkeypatch):
    """Shard i of a Stark on cuda:k sits on cuda:((k + i) % count):
    several shards share a card where fewer cards are visible."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = sharding.place(4, "cuda:1")
    assert [str(d) for d in mesh.devices] == ["cuda:1", "cuda:0", "cuda:1",
                                              "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [str(d) for d in sharding.place(4, "cuda:0").devices] == \
        ["cuda:0"] * 4


@pytest.mark.parametrize("d", [2, 4, 8])
def test_halo_wraps_to_the_first_shard(d):
    """Reshard a column-sharded (5, 3, 64) table to rows with a halo of 4:
    shard j holds its block of 64 / d rows and then the next block's
    first 4 rows; the last shard's halo is rows 0-3, shard 0's first."""
    n, halo = 64, 4
    table = torch.arange(5 * 3 * n, dtype=torch.int64).reshape(5, 3, n)
    mesh = sharding.place(d, "cpu")
    rows = sharding.all_to_all(pm.shard_columns(mesh, table), -1, 0,
                               halo=halo)
    block = n // d
    for j, part in enumerate(rows.parts):
        assert part.shape == (5, 3, block + halo)
        assert torch.equal(part[..., :block],
                           table[..., j * block:(j + 1) * block])
        nxt = (j + 1) % d * block
        assert torch.equal(part[..., block:], table[..., nxt:nxt + halo])
    assert torch.equal(rows.parts[-1][..., block:], table[..., :halo])


def test_all_to_all_refuses_an_axis_the_mesh_cannot_split():
    mesh = sharding.place(4, "cpu")
    x = pm.shard_columns(mesh, torch.zeros((4, 6), dtype=torch.int64))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.all_to_all(x, -1, 0)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard(mesh, torch.zeros(6, dtype=torch.int64), 0)


@pytest.fixture(scope="module")
def quotient_case():
    """Random committed tables of full width on the quotient domain of
    padded height 2^8 (Stark(32, 2)), with random challenges and weights,
    and the single-device combined quotient over them."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.air.challenges import SAMPLE_COUNT, Challenges
    from triton_vm_tpu_torch.air.master import master_air
    from triton_vm_tpu_torch.stark import prover

    _, _, trace_dom, _, quot_dom, _ = tvm.Stark(
        32, 2, device="cpu").derive_domains(256)
    q = quot_dom.length
    main = gf.from_u64(_field(11, (prover.NUM_MAIN, q)))
    aux = gf.from_u64(_field(12, (prover.NUM_AUX, 3, q)))
    challenges = Challenges([tuple(int(c) for c in row)
                             for row in _field(13, (SAMPLE_COUNT, 3))],
                            tvm.Claim([1, 2, 3, 4, 5], [], []))
    weights = prover._powers_xfe(
        (5, 9, 2), sum(len(cs) for cs in master_air().constraints.values()))
    want = prover._all_quotients_combined_device(
        main, aux.permute(1, 0, 2), trace_dom, quot_dom, challenges, weights)
    return main, aux, trace_dom, quot_dom, challenges, weights, want


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_quotients_match_single_device(quotient_case, d):
    main, aux, trace_dom, quot_dom, challenges, weights, want = quotient_case
    assert quot_dom.length // trace_dom.length <= quot_dom.length // d
    mesh = sharding.place(d, "cpu")
    got = pm.sharded_quotients(mesh, pm.shard_columns(mesh, main),
                               pm.shard_columns(mesh, aux), trace_dom,
                               quot_dom, challenges, weights)
    assert torch.equal(got, want)


def test_default_mesh_and_merkle_tree_adoption():
    mesh = pm.default_mesh(4, "cpu")
    assert mesh.size == 4 and pm.default_mesh(device="cpu").size == 1
    leaves = gf.from_u64(_field(21, (5, 32)))
    heap = pm.sharded_merkle_layers(mesh, sharding.shard(mesh, leaves, 1))
    tree = merkle.MerkleTree.from_flat(heap, 32)
    single = merkle.MerkleTree(leaves)
    assert tree.root() == single.root()
    assert tree.authentication_structure([3, 17, 30]) == \
        single.authentication_structure([3, 17, 30])
