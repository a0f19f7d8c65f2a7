"""The SASS reader of ``volq_torch.sass`` on a made-up disassembly in
``cuobjdump -sass``'s format (both of its branch-target spellings), on the
CPU: functions, labels, loops and their nesting, the control-flow graph
and its cycles, instruction classes."""
import pytest

from volq_torch import sass

SAMPLE = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z3fooILi1EEvPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0020*/                   LDS.U.128 R4, [R0] ;
        /*0030*/                   F2FP.BF16.F32.PACK_AB R3, RZ, R2 ;
        /*0040*/                   FMUL R3, R2, R2 ;
.L_x_1:
        /*0050*/                   IMAD.MOV.U32 R3, RZ, RZ, R2 ;
        /*0060*/               @P1 BRA `(.L_x_1) ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/              @!P0 BRA 0x20 ;
        /*0090*/                   EXIT ;
.L_x_2:
        /*00a0*/                   BRA `(.L_x_2);
		Function : _Z3barv
        /*0000*/                   MUFU.EX2 R1, R0 ;
        /*0010*/                   EXIT ;
"""


def test_parse_reads_every_function_and_instruction():
    funcs = sass.parse(SAMPLE)
    assert list(funcs) == ["_Z3fooILi1EEvPf", "_Z3barv"]
    foo = funcs["_Z3fooILi1EEvPf"]
    assert len(foo) == 11 and len(funcs["_Z3barv"]) == 2
    assert foo[2] == (0x20, "LDS.U.128", "R4, [R0]", ".L_x_0", None)
    assert foo[4][1] == "FMUL" and foo[4][3] is None
    assert foo[6][4] == "@P1" and foo[8][4] == "@!P0"


def test_loops_nest_and_skip_the_padding_branch():
    s = sass.summary(sass.parse(SAMPLE)["_Z3fooILi1EEvPf"])
    assert s["insns"] == 11
    outer, inner = s["loops"]
    assert (outer["start"], outer["end"], outer["insns"]) == (0x20, 0x80, 7)
    assert (inner["start"], inner["end"], inner["insns"]) == (0x50, 0x60, 2)
    assert (outer["depth"], inner["depth"]) == (0, 1)
    assert outer["classes"] == {"barrier": 1, "branch": 2, "convert": 1,
                                "fp32": 1, "lds": 1, "move": 1}
    assert sass.summary(sass.parse(SAMPLE)["_Z3barv"])["loops"] == []
    assert s["classes"] == {"barrier": 1, "branch": 4, "convert": 1,
                            "fp32": 1, "lds": 1, "ldg": 1, "move": 2}
    assert s["opcodes"]["BRA"] == 3 and s["opcodes"]["IMAD"] == 1


# a walk after a block barrier, a shuffle's slow path laid out after the
# exit that jumps back to before the barrier: a backward branch whose span
# holds the barrier and the walk, but no cycle through both
WALK = """
		Function : _Z4walkv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BRA.DIV UR4, `(.L_x_9) ;
.L_x_8:
        /*0020*/                   SHFL.IDX PT, R1, R0, RZ, 0x1f ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_5:
        /*0040*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0050*/                   STG.E.128 desc[UR4][R4.64], R8 ;
        /*0060*/               @P0 BRA `(.L_x_5) ;
        /*0070*/               @P1 EXIT ;
        /*0080*/                   EXIT ;
.L_x_9:
        /*0090*/                   WARPSYNC.ALL ;
        /*00a0*/                   SHFL.IDX PT, R1, R0, RZ, 0x1f ;
        /*00b0*/                   BRA `(.L_x_8) ;
.L_x_10:
        /*00c0*/                   BRA `(.L_x_10);
"""


def test_cycles_are_the_code_that_runs_again():
    walk = sass.parse(WALK)["_Z4walkv"]
    succ = sass.successors(walk)
    assert succ[1] == [9, 2]             # a branch with a condition operand
    assert succ[6] == [4, 7] and succ[7] == [8] and succ[8] == []
    assert succ[11] == [2] and succ[12] == [12]     # bare branches
    assert sass.cycles(walk) == [[4, 5, 6]]         # not the padding
    s = sass.summary(walk)
    span = [lp for lp in s["loops"] if lp["opcodes"].get("BAR")]
    assert len(span) == 1 and span[0]["opcodes"].get("LDGSTS")
    (cy,) = s["cycles"]
    assert (cy["first"], cy["last"], cy["insns"]) == (0x40, 0x60, 3)
    assert cy["opcodes"] == {"BRA": 1, "LDGSTS": 1, "STG": 1}
    # nested loops are one cycle, the barrier inside it
    foo = sass.parse(SAMPLE)["_Z3fooILi1EEvPf"]
    assert sass.cycles(foo) == [[2, 3, 4, 5, 6, 7, 8]]
    assert sass.summary(foo)["cycles"][0]["opcodes"]["BAR"] == 1
    assert sass.cycles(sass.parse(SAMPLE)["_Z3barv"]) == []


@pytest.mark.parametrize("op,cls", [
    ("LDS.U.128", "lds"), ("LDG.E.128.CONSTANT", "ldg"),
    ("LDGSTS.E.BYPASS.128", "cp_async"), ("IMAD.MOV.U32", "move"),
    ("IMAD.WIDE", "int"), ("F2FP.BF16.F32.PACK_AB", "convert"),
    ("MUFU.EX2", "mufu"), ("FSETP.GE.AND", "compare"),
    ("BAR.SYNC.DEFER_BLOCKING", "barrier"), ("HMMA.16816.F32", "mma"),
    ("HMMA.16816.F32.BF16", "mma"), ("HGMMA.64x80x16.F32.BF16", "mma"),
    ("WARPGROUP.DEPBAR.LE", "mma"), ("WARPGROUP.ARRIVE", "mma"),
    ("UTMALDG.3D", "tma"), ("UTMALDG.2D", "tma"), ("UTMASTG.2D", "tma"),
    ("UBLKCP.S.G", "tma"), ("LDGDEPBAR", "cp_async"),
    ("SYNCS.ARRIVE.TRANS64.A1T0", "mbarrier"),
    ("SYNCS.PHASECHK.TRANS64.TRYWAIT", "mbarrier"), ("NOP", "other")])
def test_classify_by_longest_prefix(op, cls):
    assert sass.classify(op) == cls
