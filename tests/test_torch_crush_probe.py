"""crush_probe.py's SASS counter on hand-written listings.

The listings have the shape ``cuobjdump -sass`` prints: ``SASS`` a loop
that branches around blocks and calls a straight-line routine (the path
walker's cases); ``_draw_sass`` ``crush_straw2_winners``' item loop as
built with the reciprocal division, two draws per iteration; ``_gf_sass``
gf_apply's row loop.  The counts are exact.  Also the CRUSH bound's
operation count (chip_smoke.crush_ops_ms).
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


def _draw_sass(call=False, ool=False):
    """``crush_straw2_winners`` as compiled since the reciprocal: a
    table-staging loop, a collision-style loop (shared loads, one shift),
    then the item loop, two draws per iteration.  Each draw skips on a
    zero weight, runs a 32-instruction hash run (16 right shifts), takes
    crush_ln's normalisation block on half the hashes, reads the ln
    tables twice and divides by a multiply-high and a compare.  With
    ``call``, the loop also calls a routine (the emulated division); with
    ``ool``, the normalisation blocks sit after the kernel's EXIT and
    branch back, and the loop's first instruction may leave it for the
    EXIT."""
    def draw(skip):
        return (["LDG.E.64.CONSTANT R10, desc[UR4][R12.64]",
                 "ISETP.GE.AND P2, PT, R10, 0x1, PT", f"@!P2 BRA {skip}"]
                + ["SHF.R.U32.HI R14, RZ, 0xd, R15"] * 16
                + ["IADD3 R15, R15, -R14, -R16"] * 8
                + ["LOP3.LUT R15, R15, R14, RZ, 0x96, !PT"] * 8
                + ["ISETP.GE.U32.AND P3, PT, R15, 0x8000, PT", "NORM"]
                + ["FLO.U32 R17, R15", "SHF.L.U32 R15, R15, R17, RZ"]
                + ["LDS.128 R20, [R18]", "LDS.64 R24, [R19]",
                   "IMAD.WIDE.U32 R26, R15, R20, RZ",
                   "IMAD.HI.U32 R27, R28, R29, RZ",
                   "ISETP.GE.U32.AND P4, PT, R30, R31, PT",
                   "SEL R32, R33, R34, P4"])
    body = ["LDC R1, c[0x0][0x28]",
            "LDG.E.64 R2, desc[UR4][R2.64]", "STS.64 [R5], R2",
            "@P0 BRA 0x10",
            "LDS R6, [R7]", "SHF.R.U32.HI R8, RZ, 0x1, R6", "@P1 BRA 0x40"]
    start = len(body)
    if ool:
        body.append("@P5 BRA LOOP_EXIT")
    d0 = draw("SKIP0")
    d1 = draw("SKIP1")
    body += d0 + d1
    body += ["IADD3 R9, R9, 0x10, RZ"] + (["CALL.REL.NOINC SUB"] if call
                                           else [])
    body += ["ISETP.GE.AND P0, PT, R9, R35, PT", f"@!P0 BRA {16 * start:#x}"]
    stop = len(body) - 1
    body += ["EXIT", "IMAD.WIDE.U32 R6, R4, R2, RZ", "RET.REL.NODEC R14 0x0"]
    out = []
    for i, text in enumerate(body):
        if text == "NORM":                  # over the normalisation block
            text = f"@P3 BRA {16 * (i + 3):#x}"
            if ool:                         # out to it and back
                text = f"@!P3 BRA {16 * len(body):#x}"
                body += [body[i + 1], body[i + 2], f"BRA {16 * (i + 3):#x}"]
                body[i + 1] = body[i + 2] = "NOP"
        out.append(text)
    out += body[len(out):]
    i1 = start + (1 if ool else 0) + len(d0)
    end = i1 + len(d1)
    out = [t.replace("SKIP0", f"{16 * i1:#x}").replace("SKIP1",
                                                       f"{16 * end:#x}")
           .replace("SUB", f"{16 * (stop + 2):#x}")
           .replace("LOOP_EXIT", f"{16 * (stop + 1):#x}") for t in out]
    return _listing(DRAW_NAME, out), start, stop


DRAW_NAME = ("_ZN45_GLOBAL__N__8d1e2a2a_12_crush_map_cu_08b4ef1027crush_straw2_"
             "winners_kernelEPKiPKliS3_S3_xS3_iPl")


def test_draw_cost_is_the_mean_of_the_calling_paths():
    """The item loop is found by its hash run, not by a CALL; per draw,
    the mean of the paths on which both items draw, halved."""
    sass, start, stop = _draw_sass()
    cost = cp.draw_cost(sass)
    assert cost["function"] == DRAW_NAME
    assert cost["loops"] == [[hex(16 * start), hex(16 * stop)]]
    assert cost["calls_in_loop"] == 0
    # each draw: skip, or draw with or without the normalisation block
    assert len(cost["paths"]) == 9
    assert sorted(d["issue"] for d in cost["draw_paths"]) == [
        44.5, 45.5, 45.5, 46.5]
    per = cost["per_draw"]
    # per draw: the weight check, 32 hash instructions, the normalisation
    # test, half a normalisation shift, the compare and select, half the
    # loop's two ALU instructions; two IMADs; two shared loads and the
    # weight load; two branches and half the loop's
    assert per == {"alu": 37.5, "fma": 2, "slow": 0.5, "mem": 3,
                   "uniform": 0, "control": 2.5, "issue": 45.5}
    assert cost["sm_clocks_per_draw"] == 37.5 / 64 == max(
        37.5 / 64, 2 / 64, 0.5 / 16, 3 / 32, 45.5 / 128)
    sass, start, stop = _draw_sass(call=True)
    cost = cp.draw_cost(sass)
    assert cost["calls_in_loop"] == 1
    assert cost["per_draw"]["issue"] == 45.5 + (1 + 2) / 2


def test_draw_cost_follows_blocks_placed_after_the_loop():
    """Normalisation blocks moved past the EXIT and back add one branch on
    the paths that take them; the loop's exit to the EXIT is no path."""
    sass, start, stop = _draw_sass(ool=True)
    with pytest.raises(ValueError, match="leaves the loop"):
        cp.loop_paths(cp.functions(sass)[DRAW_NAME], 16 * start, 16 * stop)
    cost = cp.draw_cost(sass)
    assert cost["loops"] == [[hex(16 * start), hex(16 * stop)]]
    assert len(cost["paths"]) == 9
    # per draw, half the loop-top branch and the branch back on half of
    # the draws: 0.5 + 0.5 more than test_draw_cost_is_the_mean_...
    assert cost["per_draw"] == {"alu": 37.5, "fma": 2, "slow": 0.5,
                                "mem": 3, "uniform": 0, "control": 3.5,
                                "issue": 46.5}


def test_map_kernels_name_each_instantiation():
    names = [f"_ZN45_GLOBAL__N__8d1e_12_crush_map_cu_16crush_map_kernelILb{f}"
             f"ELi{g}ELb{u}EEEvNS_6ParamsEPKiPKlPKmS5_S5_S5_xPi"
             for f in (0, 1) for g in (1, 16) for u in (0, 1)]
    sass = "".join(_listing(n, ["EXIT"]) for n in names)
    got = cp.map_kernels(sass)
    assert sorted(got) == [(f, g, u) for f in (False, True)
                           for g in (1, 16) for u in (False, True)]
    assert got[True, 16, False] == names[6]


def test_crush_floor_counts_136_per_draw_and_82_per_is_out_hash():
    import chip_smoke
    work = {"straw2_draws": 1_000_000, "perm_hashes": 2_000,
            "is_out_hashes": 30_000}
    ops = 136 * (1_000_000 + 2_000) + 82 * 30_000
    # 46 and 28 of them xors, which only the ALU pipe issues: the SM's
    # issue rate over all operations binds first
    assert 46 * (1_000_000 + 2_000) + 28 * 30_000 < ops / 2
    assert chip_smoke.crush_ops_ms(work) == pytest.approx(
        ops / 128 / (132 * 1.98e9) * 1e3, rel=1e-12)
    assert chip_smoke.crush_ops_ms({"is_out_hashes": 64}) == pytest.approx(
        82 / 2 / (132 * 1.98e9) * 1e3, rel=1e-12)
    assert chip_smoke.crush_ops_ms({}) == 0
    # a draw: 1.0625 SM clocks; the ALU term binds when xors dominate
    assert chip_smoke.hash_sm_clocks(136, 46) == 136 / 128
    assert chip_smoke.hash_sm_clocks(100, 80) == 80 / 64


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
    assert rep == {GF_NAME: {"registers": 40, "stack_frame": 0,
                             "spill_stores": 0, "spill_loads": 0},
                   GF_BYTES: {"registers": 255, "stack_frame": 8,
                              "spill_stores": 4, "spill_loads": 8}}
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
        "vec": {"registers": 40, "stack_frame": 0, "spill_stores": 0,
                "spill_loads": 0},
        "bytes": {"registers": 255, "stack_frame": 8, "spill_stores": 4,
                  "spill_loads": 8}}
    assert rep[(256, 16, 2), True]["ptxas"] == {"vec": {}, "bytes": {}}
