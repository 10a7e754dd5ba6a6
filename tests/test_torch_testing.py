"""The port's `TestableProgram` (triton_vm_tpu_torch.testing) and the
Stark API it needs: `with_ldt_choice`, `with_soundness` and
`low_security` keep the device and derive the JAX package's domains and
low-degree-test parameters; a low-security proof of fibonacci input 7
hashes to the JAX package's; `Stir` and `StirParameters` are exported
at the top level, as the JAX package exports them."""

import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu.stark.prover import Stark as JStark
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.ldt import stir
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.testing import TestableProgram

torch.set_num_threads(2)

SEED = bytes(range(32))
# tip5.hash_varlen([len(w) + 1, len(w)] + w) of the JAX package's
# low-security proof of fibonacci input 7, computed on the CPU with:
#   JAX_PLATFORMS=cpu python -c "
#   from triton_vm_tpu.models import example_programs as ex
#   from triton_vm_tpu.testing import TestableProgram
#   from triton_vm_tpu.crypto import tip5
#   w = TestableProgram(ex.fibonacci()).with_input([7]) \
#       .prove_and_verify(seed=bytes(range(32))).words
#   print(tip5.hash_varlen([len(w) + 1, len(w)] + w))"
JAX_LOW_SECURITY_FIB7_DIGEST = (5451660588470763885, 7307061866663976276,
                                14817866948123220096, 49005092894082727,
                                15240332116246682258)


def _params(stark, height):
    ldt, ntr, trace, rand, quot, ldt_dom = stark.derive_domains(height)
    return (type(ldt).__name__, ntr, trace.length, rand.length,
            quot.length, quot.offset, ldt_dom.length, ldt_dom.offset,
            ldt.num_first_round_queries())


def test_with_methods_keep_the_device():
    s = tvm.Stark(security_level=100, device="cpu")
    for copy in (s.with_ldt_choice("stir"), s.with_soundness("conjectured"),
                 tvm.Stark.low_security(device="cpu")):
        assert copy.device == torch.device("cpu")
    t = s.with_ldt_choice("stir").with_soundness("conjectured")
    assert (t.security_level, t.log2_ldt_expansion_factor, t.ldt_choice,
            t.soundness) == (100, 2, "stir", "conjectured")
    assert s.ldt_choice is None and s.soundness == "proven"
    low = tvm.Stark.low_security(device="cpu")
    assert (low.security_level, low.log2_ldt_expansion_factor) == (32, 2)


def test_low_security_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tvm.Stark.low_security().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tvm.Stark.low_security()
        tp = TestableProgram(ex.fibonacci()).with_input([7])
        assert tp.run() == [21]
        with pytest.raises(RuntimeError):
            tp.prove()


@pytest.mark.parametrize("height", [1 << 8, 1 << 10, 1 << 16, 1 << 17])
@pytest.mark.parametrize("variant", ["low_security", "stir", "conjectured"])
def test_stark_parameters_equal_jax(height, variant):
    mine = tvm.Stark.low_security(device="cpu")
    theirs = JStark.low_security()
    if variant == "stir":
        mine, theirs = (mine.with_ldt_choice("stir"),
                        theirs.with_ldt_choice("stir"))
    elif variant == "conjectured":
        mine = tvm.Stark(device="cpu").with_soundness("conjectured")
        theirs = JStark().with_soundness("conjectured")
    assert _params(mine, height) == _params(theirs, height)


def test_testable_program_prove_and_verify_equals_jax():
    tp = (TestableProgram(ex.fibonacci()).with_input([7])
          .use_stark(tvm.Stark.low_security(device="cpu")))
    proof = tp.prove_and_verify(seed=SEED)
    w = proof.words
    assert proof.padded_height() == 512 and len(w) == 35855
    assert (tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w))
            == JAX_LOW_SECURITY_FIB7_DIGEST)
    assert tp.run() == [21]
    aet, output = tp.trace_execution()
    assert output == [21] and aet.padded_height() == 512


def test_stir_is_exported():
    assert tvm.Stir is stir.Stir
    assert tvm.StirParameters is stir.StirParameters
    assert isinstance(tvm.Stark(device="cpu").ldt(1 << 16), tvm.Stir)
