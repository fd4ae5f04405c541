"""tool/kernel_sass.py's counts on a hand-written SASS listing: the
accurate sinf/cosf's slow path set apart, the integer and f32 pipes, and
one turn of the outermost loop (kernel B's bound reads these)."""
import pytest

from mlmc_tpu_torch.tool import kernel_sass

LISTING = """
        Function : _Z19normals_dump_kernelPfllj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;               /* 0x0000000000007919 */
        /*0020*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
        /*0030*/                   FSETP.GE.AND P0, PT, |R5|, 105615, PT ;
        /*0040*/              @!P0 BRA 0x80 ;
        /*0050*/                   STL [R1], R2 ;
        /*0060*/                   LDL.64 R2, [R1] ;
        /*0070*/                   LOP3.LUT R4, R2, R3, R4, 0x96, !PT ;
        /*0080*/                   FFMA R6, R5, R7, R8 ;
        /*0090*/                   STL [R1+0x4], R6 ;
        /*00a0*/                   MUFU.SIN R9, R6 ;
        /*00b0*/               @P1 BRA 0x20 ;
        /*00c0*/                   IADD3 R0, R0, 0x1, RZ ;
        /*00d0*/                   EXIT ;
        Function : _Z6branchPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*0030*/               @P0 BRA 0x70 ;
        /*0040*/                   IMAD R4, R0, R0, RZ ;
        /*0050*/                   IMAD R4, R4, R0, RZ ;
        /*0060*/                   LOP3.LUT R4, R4, R0, RZ, 0x3c, !PT ;
        /*0070*/                   FADD R5, R4, R4 ;
        /*0080*/               @P1 BRA 0x10 ;
        /*0090*/                   EXIT ;
        Function : _Z11gram_reducePKd
        /*0000*/                   DMMA.8x8x4 R0, R2, R4, R0 ;
        /*0010*/                   DFMA R6, R2, R4, R6 ;
        /*0020*/                   EXIT ;
"""


def test_count_sass_sets_the_trig_slow_path_apart_and_counts_one_loop_turn():
    counts = kernel_sass.count_sass(LISTING)
    b = counts["_Z19normals_dump_kernelPfllj"]
    # 0x50-0x70 lie in the slow path: their local accesses count only in *_ALL
    assert (b["LDL"], b["STL"], b["LDL_ALL"], b["STL_ALL"]) == (0, 1, 1, 2)
    assert (b["INT"], b["F32"]) == (2, 3)  # IMAD.WIDE, IADD3; FSETP, FFMA, MUFU
    assert (b["LOOP_INT"], b["LOOP_F32"]) == (1, 3)  # 0x20-0xb0, IADD3 after it
    # one turn may take the branch past 0x40-0x60: the fewest instructions
    branch = counts["_Z6branchPf"]
    assert (branch["INT"], branch["LOOP_INT"], branch["LOOP_F32"]) == (5, 2, 1)
    reduce_ = counts["_Z11gram_reducePKd"]
    assert (reduce_["DMMA"], reduce_["DFMA"], reduce_["LOOP_INT"]) == (1, 1, 0)


@pytest.mark.parametrize("mangled, short", [
    ("_Z17synth_mlmc_kernelILi4EEvPKfPKl", "A NB=4"),
    ("_Z19samples_gram_kernelILi2EfEv10SampleRowsIT0_E", "C NB=2"),
    ("_Z19samples_gram_kernelILi3EdEv10SampleRowsIT0_E", "D NB=3"),
    ("_Z19normals_dump_kernelPflljjj", "B"),
    ("_ZN4gram11gram_reduceEPKd", None),
])
def test_short_names(mangled, short):
    assert kernel_sass._short_name(mangled) == short


def test_count_sass_reads_the_registers_setmaxnreg_gives_each_role():
    listing = """
        Function : _Z17synth_mlmc_kernelILi4EEvPKfPKl
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.U32.AND P1, PT, R0, 0x80, PT ;
        /*0020*/               @P1 BRA 0x60 ;
        /*0030*/                   USETMAXREG.TRY_ALLOC.CTAPOOL P0, 0xf0 ;
        /*0040*/              @!P0 BRA 0x30 ;
        /*0050*/                   EXIT ;
        /*0060*/                   USETMAXREG.DEALLOC.CTAPOOL 0x58 ;
        /*0070*/                   EXIT ;
"""
    counts = kernel_sass.count_sass(listing)["_Z17synth_mlmc_kernelILi4EEvPKfPKl"]
    assert counts["ROLES"] == [240, 88]
    assert kernel_sass.count_sass(LISTING)["_Z6branchPf"]["ROLES"] == []
