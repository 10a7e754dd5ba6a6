"""The readers behind the kernel tables of PERF.md (ops/tip5_cuda.py's
ptxas report, tools/tip5_probe.py's occupancy and SASS counts), on
listings in the formats nvcc and cuobjdump print. No card needed."""

from triton_vm_tpu_torch.ops import tip5_cuda
from triton_vm_tpu_torch.tools import tip5_probe

PTXAS = """\
ptxas info    : 0 bytes gmem, 640 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123tip5_sponge_rows_kernelEPKmllllPm' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123tip5_sponge_rows_kernelEPKmllllPm
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 165 registers, 256 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123tip5_permutation_kernelEPKmPml' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123tip5_permutation_kernelEPKmPml
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 256 bytes smem, 392 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_123tip5_permutation_kernelEPKmPml
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   IMAD.WIDE.U32 R2, R0, 0x8, R2 ;
        /*0020*/              @!P0 IADD3.X R2, R0, 0x8, R2, P1, !PT ;
        /*0030*/                   LDS.U8 R2, [R3] ;
        /*0040*/                   IMAD.MOV.U32 R4, RZ, RZ, R2 ;
        /*0050*/               @P0 BRA `(.L_x_1) ;
        /*0060*/                   EXIT ;
"""


def test_ptxas_report_reads_each_kernel(tmp_path):
    so = tmp_path / "libtip5_x.so"
    so.with_suffix(".ptxas.txt").write_text(PTXAS)
    assert tip5_cuda.ptxas_report(so) == {
        "tip5_sponge_rows_kernel": dict(stack=0, spill_stores=8,
                                        spill_loads=4, registers=165,
                                        smem=256),
        "tip5_permutation_kernel": dict(stack=0, spill_stores=0,
                                        spill_loads=0, registers=96,
                                        smem=256)}


def test_resident_warps_follow_register_allocation():
    # 65,536 registers an SM, allocated 256 a warp, 4-warp blocks
    assert tip5_probe.resident_warps(96) == 20
    assert tip5_probe.resident_warps(128) == 16
    assert tip5_probe.resident_warps(165) == 12
    assert tip5_probe.resident_warps(32) == 64


def test_sass_counts_find_the_loop_and_classes():
    kernels = tip5_probe.parse_sass(SASS)
    k = kernels["tip5_permutation_kernel"]
    assert tip5_probe.count(k["insns"])["total"] == 7
    (loop,) = tip5_probe.loops(k)
    assert (loop["from"], loop["to"], loop["total"]) == ("0x10", "0x50", 5)
    assert loop["classes"] == {"IMAD": 0, "IMAD.WIDE": 1, "IMAD.HI": 0,
                               "IMAD as move/add/shift": 1, "IADD3": 1,
                               "LDS": 1, "SEL/branch": 1, "other": 0}
