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


# -- gf_apply's row loop ------------------------------------------------------

GF_NAME = ("_ZN12_GLOBAL__N_115gf_apply_kernelILi256ELi16ELi2ELb1ELb0EEE"
           "vPKhiiiS2_xPhxxPj")
GF_BYTES = GF_NAME.replace("ELb1ELb0E", "ELb0ELb0E")


def _listing(name, body):
    lines = [f"\t\tFunction : {name}"]
    lines += [f"        /*{16 * i:04x}*/                   {text} ;  /* 0x0 */"
              for i, text in enumerate(body)]
    return "\n".join(lines) + "\n"


def _gf_sass():
    """A 16-byte-path kernel of (256, 16, 2) whose row loop serves 0, 1 or
    2 output rows of 4 words (12 PRMT and 8 LOP3 each), and a byte-path
    kernel whose loop loads bytes."""
    sel = ["LOP3.LUT R8, R4, 0x7070707, RZ, 0xc0, !PT",
           "SHF.R.U32.HI R9, RZ, 0x3, R4",
           "LOP3.LUT R9, R9, 0x7070707, RZ, 0xc0, !PT",
           "SHF.R.U32.HI R10, RZ, 0x6, R4",
           "LOP3.LUT R10, R10, 0x3030303, RZ, 0xc0, !PT",
           "LEA.HI R8, R8, R8, RZ, 0x14", "LEA.HI R9, R9, R9, RZ, 0x14",
           "LEA.HI R10, R10, R10, RZ, 0x14"] * 4
    row = (["LDS.128 R12, [R3]", "LDS R16, [R3+0x10]"]
           + ["PRMT R17, R12, R8, R13"] * 12
           + ["LOP3.LUT R20, R20, R17, R18, 0x96, !PT"] * 8)
    start = 2
    body = ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X",
            "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]"] + sel
    guard1 = len(body) + 1
    body += ["ISETP.GE.AND P1, PT, R11, 0x1, PT", None] + row
    guard2 = len(body) + 1
    body += ["ISETP.GE.AND P2, PT, R11, 0x2, PT", None] + row
    end = len(body)
    body += ["IADD3 R7, R7, 0x1, RZ", "IMAD.WIDE R2, R5, 0x1, R2",
             "ISETP.GE.AND P0, PT, R7, R6, PT", f"@P0 BRA {16 * start:#x}",
             "EXIT"]
    body[guard1] = f"@!P1 BRA {16 * end:#x}"
    body[guard2] = f"@!P2 BRA {16 * end:#x}"
    byte_loop = ["LDC R1, c[0x0][0x28]",
                 "LDG.E.U8.CONSTANT R4, desc[UR4][R2.64]",
                 "PRMT R5, R4, 0x3120, RZ", "@P0 BRA 0x10", "EXIT"]
    return _listing(GF_NAME, body) + _listing(GF_BYTES, byte_loop)


def test_gf_word_cost_counts_each_row_count_per_word():
    cost = cp.gf_word_cost(cp.functions(_gf_sass()), (256, 16, 2))
    assert cost["function"] == GF_NAME and cost["words_per_thread"] == 4
    per = cost["per_word"]
    assert sorted(per) == [0, 1, 2]
    # 0 rows: 32 selector ops and 3 loop ops on the ALU, the IMAD, the
    # load, the guard's and the loop's branches
    assert per[0] == {"alu": 35 / 4, "fma": 1 / 4, "slow": 0, "mem": 1 / 4,
                      "uniform": 0, "control": 2 / 4, "issue": 39 / 4}
    assert per[2] == {"alu": 76 / 4, "fma": 1 / 4, "slow": 0, "mem": 5 / 4,
                      "uniform": 0, "control": 3 / 4, "issue": 85 / 4}
    assert cost["per_row"]["alu"] == (76 - 35) / 2 / 4
    assert cost["base"] == per[0]
    with pytest.raises(ValueError, match="no gf_apply_kernel"):
        cp.gf_word_cost(cp.functions(_gf_sass()), (128, 16, 2))


def test_gf_floor_takes_each_row_tile_on_its_busiest_pipe():
    cost = cp.gf_word_cost(cp.functions(_gf_sass()), (256, 16, 2))
    clocks = {rows: cp.sm_clocks(by) for rows, by in cost["per_word"].items()}
    assert clocks[2] == 76 / 4 / 64
    L, per_s = 1 << 20, 1e12
    assert cp.gf_floor_ms(cost, 8, 4, L, per_s) == pytest.approx(
        L / 4 * 8 * 2 * clocks[2] / per_s * 1e3)
    assert cp.gf_floor_ms(cost, 8, 3, L, per_s) == pytest.approx(
        L / 4 * 8 * (clocks[2] + clocks[1]) / per_s * 1e3)
    del cost["per_word"][1]        # a row count no path served: the fit
    fit = {p: cost["base"][p] + cost["per_row"][p] for p in cost["base"]}
    assert cp.gf_floor_ms(cost, 8, 3, L, per_s) == pytest.approx(
        L / 4 * 8 * (clocks[2] + cp.sm_clocks(fit)) / per_s * 1e3)


PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{GF_NAME}' for 'sm_90a'
ptxas info    : Function properties for {GF_NAME}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '{GF_BYTES}' for 'sm_90a'
ptxas info    : Function properties for {GF_BYTES}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 376 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = cp.ptxas_report(PTXAS)
    assert rep == {GF_NAME: {"registers": 40, "spill_stores": 0,
                             "spill_loads": 0},
                   GF_BYTES: {"registers": 255, "spill_stores": 4,
                              "spill_loads": 8}}
    funcs = cp.functions(_gf_sass())
    assert cp.gf_kernel(funcs, (256, 16, 2), vec=False) == GF_BYTES


def test_gf_report_joins_costs_and_registers(monkeypatch):
    """gf_report on a built library: one cost per variant and entry, each
    with the registers of its 16-byte-path and byte-path kernels."""
    from types import SimpleNamespace

    from ceph_tpu_torch.ec import kernel
    sums = [GF_NAME.replace("ELb1ELb0E", "ELb1ELb1E"),
            GF_NAME.replace("ELb1ELb0E", "ELb0ELb1E")]
    sass = _gf_sass() + "".join(_listing(n, ["EXIT"]) for n in sums)
    monkeypatch.setattr(cp, "disassemble", lambda path: sass)
    monkeypatch.setattr(kernel, "TUNE_SPACE", [(256, 16, 2)])
    monkeypatch.setattr(cp, "gf_word_cost",
                        lambda funcs, variant, checksum=False: {})
    rep = cp.gf_report(SimpleNamespace(path="lib.so", ptxas=PTXAS))
    assert list(rep) == [((256, 16, 2), False), ((256, 16, 2), True)]
    assert rep[(256, 16, 2), False]["ptxas"] == {
        "vec": {"registers": 40, "spill_stores": 0, "spill_loads": 0},
        "bytes": {"registers": 255, "spill_stores": 4, "spill_loads": 8}}
    assert rep[(256, 16, 2), True]["ptxas"] == {"vec": {}, "bytes": {}}
