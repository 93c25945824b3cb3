"""crush_probe.py's SASS counter on a hand-written listing.

The listing has the shape ``cuobjdump -sass`` prints for
``crush_straw2_winners``: a table-staging loop, then an item loop whose
draw branches around a skipped item, a conditional block and a 32-bit
division shortcut, and calls a straight-line division routine.  The
counts are exact.
"""

import pytest

import crush_probe as cp

SASS = """
	code for sm_90a
		Function : _Z27crush_straw2_winners_kernelPKi
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0 */
        /*0010*/                   STS.64 [R11], R2 ;              /* 0x0 */
        /*0020*/              @!P0 BRA 0x10 ;                      /* 0x0 */
        /*0030*/                   ISETP.GE.AND P0, PT, R0, 0x1, PT ; /* 0x0 */
        /*0040*/                   LDG.E.64.CONSTANT R16, desc[UR10][R16.64] ; /* 0x0 */
        /*0050*/              @!P0 BRA 0x100 ;                     /* 0x0 */
        /*0060*/                   IADD3 R5, -R4, R0, -R3 ;        /* 0x0 */
        /*0070*/                   IMAD.SHL.U32 R7, R5, 0x100, RZ ; /* 0x0 */
        /*0080*/               @P0 BRA 0xa0 ;                      /* 0x0 */
        /*0090*/                   FLO.U32 R2, R3 ;                /* 0x0 */
        /*00a0*/                   LDS.128 R4, [R6+UR5+-0x800] ;   /* 0x0 */
        /*00b0*/              @!P0 BRA 0xe0 ;                      /* 0x0 */
        /*00c0*/                   CALL.REL.NOINC 0x140 ;          /* 0x0 */
        /*00d0*/                   BRA 0x100 ;                     /* 0x0 */
        /*00e0*/                   I2F.U32.RP R4, R16 ;            /* 0x0 */
        /*00f0*/               @P0 VIADD R2, R2, 0x1 ;             /* 0x0 */
        /*0100*/                   UIADD3 UR14, UP0, UR14, 0x4, URZ ; /* 0x0 */
        /*0110*/                   SEL R9, R2, R9, P0 ;            /* 0x0 */
        /*0120*/              @!P1 BRA 0x30 ;                      /* 0x0 */
        /*0130*/                   EXIT ;                          /* 0x0 */
        /*0140*/                   IMAD.WIDE.U32 R6, R4, R2, RZ ;  /* 0x0 */
        /*0150*/                   MUFU.RCP R19, R19 ;             /* 0x0 */
        /*0160*/                   LOP3.LUT R6, R17, R15, RZ, 0x3c, !PT ; /* 0x0 */
        /*0170*/                   RET.REL.NODEC R14 0x0 ;         /* 0x0 */
        /*0180*/                   BRA 0x180;                      /* 0x0 */
        /*0190*/                   NOP;                            /* 0x0 */
		..........
"""


def test_functions_parse_addresses_and_predicates():
    funcs = cp.functions(SASS)
    (name, insns), = funcs.items()
    assert name == "_Z27crush_straw2_winners_kernelPKi"
    assert len(insns) == 26
    assert insns[0x20] == ("BRA 0x10", "@!P0 BRA 0x10")
    assert insns[0x90][0] == "FLO.U32 R2, R3"


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", "alu"), ("LOP3", "alu"), ("SHF", "alu"), ("SEL", "alu"),
    ("VIADD", "alu"), ("IMAD", "fma"), ("FLO", "slow"), ("MUFU", "slow"),
    ("I2F", "slow"), ("LDS", "mem"), ("LDG", "mem"), ("UIADD3", "uniform"),
    ("S2UR", "uniform"), ("BRA", "control"), ("CALL", "control"),
    ("BSSY", "control")])
def test_pipe_of(op, pipe):
    assert cp.pipe_of(op) == pipe


def test_loop_paths_follow_branches_and_calls():
    insns = cp.functions(SASS)["_Z27crush_straw2_winners_kernelPKi"]
    paths = cp.loop_paths(insns, 0x30, 0x120)
    assert sorted(len(p) for p in paths) == [6, 13, 14, 17, 18]
    skipped = min(paths, key=len)
    assert skipped[-1] == "BRA 0x30" and "UIADD3 UR14, UP0, UR14, 0x4, URZ" \
        in skipped
    longest = max(paths, key=len)
    assert "FLO.U32 R2, R3" in longest and "RET.REL.NODEC R14 0x0" in longest


def test_draw_cost_is_the_mean_of_the_calling_paths():
    cost = cp.draw_cost(SASS)
    assert cost["loop"] == ["0x30", "0x120"]
    assert [d["issue"] for d in cost["draw_paths"]] == [18, 17]
    per = cost["per_draw"]
    # ISETP IADD3 SEL on the ALU, LOP3 in the call; FLO on half the paths;
    # five branches, the CALL and the RET take issue slots only
    assert per == {"alu": 4, "fma": 2, "slow": 1.5, "mem": 2, "uniform": 1,
                   "control": 7, "issue": 17.5}
    assert cost["sm_clocks_per_draw"] == max(4 / 64, 2 / 64, 1.5 / 16,
                                             2 / 32, 17.5 / 128)


def test_a_branch_out_of_the_loop_is_refused():
    insns = dict(cp.functions(SASS)["_Z27crush_straw2_winners_kernelPKi"])
    insns[0x80] = ("BRA 0x130", "@P0 BRA 0x130")
    with pytest.raises(ValueError, match="leaves the loop"):
        cp.loop_paths(insns, 0x30, 0x120)
