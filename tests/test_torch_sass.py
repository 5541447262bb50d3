"""firedancer_tpu_torch.utils.sass on a cuobjdump -sass listing written out
here (cuobjdump runs only where the CUDA toolkit is): a loop's instructions
by opcode and its longest dependent chain, for a branch to a label and to
an address, counting only the named kernel's loops."""
import pytest

from firedancer_tpu_torch.utils import sass

LISTING = """
        Function : other_kernel
        /*0000*/                   IADD3 R2, R0, 0x1, RZ ;
        /*0010*/                   BRA 0x0 ;
        Function : chain_kernel
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;
        /*0030*/                   SHF.R.U32.HI R3, RZ, 0x2, R2 ;
        /*0040*/                   LDS.128 R8, [R0+0x10] ;
        /*0050*/                   LOP3.LUT R4, R3, R2, R8, 0x96, !PT ;
        /*0060*/                   STS [R0], R4 ;
        /*0070*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*0080*/               @P0 BRA {target} ;
        /*0090*/                   EXIT ;
.L_x_2:
        /*00a0*/                   BRA `(.L_x_2) ;
"""


@pytest.mark.parametrize("target", ["`(.L_x_1)", "0x20"])
def test_loops_count_the_named_kernels_loop(target):
    (lp,) = sass.loops(LISTING.format(target=target), "chain_kernel")
    assert lp["n"] == 7
    assert lp["ops"] == {"IADD3": 1, "SHF": 1, "LDS": 1, "LOP3": 1, "STS": 1, "ISETP": 1,
                         "BRA": 1}
    # IADD3 -> SHF -> LOP3 -> ISETP; LDS reads only the live-in R0
    assert lp["depth"] == 4


def test_loops_of_a_kernel_not_in_the_listing_raise():
    with pytest.raises(ValueError):
        sass.loops(LISTING.format(target="0x20"), "missing_kernel")


CALL_LISTING = """
        Function : mul_kernel
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0010*/                   MOV R4, R0 ;
        /*0020*/                   CALL.REL.NOINC {target} ;
        /*0030*/                   IADD3 R0, R4, 0x1, RZ ;
        /*0040*/                   ISETP.NE.AND P0, PT, R0, RZ, PT ;
        /*0050*/               @P0 BRA `(.L_x_1) ;
        /*0060*/                   EXIT ;
.L_x_2:
        /*0070*/                   IMAD.WIDE R4, R4, R4, RZ ;
        /*0080*/                   IMAD.WIDE R4, R4, R4, R4 ;
        /*0090*/                   RET.REL.NODEC R2 0x0 ;
        Function : fe_mul
        /*0000*/                   IMAD.WIDE R4, R4, R4, RZ ;
        /*0010*/                   RET.ABS.NODEC R20 0x0 ;
"""


@pytest.mark.parametrize("target,called,imad", [("`(.L_x_2)", 3, 2), ("0x70", 3, 2),
                                                ("`(fe_mul)", 2, 1)])
def test_loops_count_a_called_functions_instructions(target, called, imad):
    """A CALL in the loop adds its callee's instructions, to its RET, to the
    loop's count: a subroutine of the kernel (by label or address) or
    another function of the listing (by name)."""
    (lp,) = sass.loops(CALL_LISTING.format(target=target), "mul_kernel")
    assert lp["called"] == called and lp["n"] == 5 + called
    assert lp["ops"]["IMAD"] == imad and lp["ops"]["CALL"] == 1 and lp["ops"]["RET"] == 1
    assert lp["forms"]["IMAD.WIDE"] == imad and lp["forms"]["CALL.REL.NOINC"] == 1


@pytest.mark.parametrize("flag,want", [([], "SHF 1"), (["--forms"], "SHF.R.U32.HI 1")])
def test_main_prints_opcodes_or_their_forms(monkeypatch, capsys, flag, want):
    monkeypatch.setattr(sass, "dump", lambda so: LISTING.format(target="0x20"))
    assert sass.main([*flag, "lib.so", "chain_kernel"]) == 0
    out = capsys.readouterr().out
    assert "lib.so chain_kernel loop 0: 7 instructions" in out and want in out


STALL_LISTING = """
        Function : mad_kernel
.L_x_3:
        /*0000*/                   IMAD.WIDE R4, R2, R3, R4 ;        /* 0x0000000302047225 */
                                                                    /* 0x{w0:016x} */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;           /* 0x0000000102027810 */
                                                                    /* 0x{w1:016x} */
        /*0020*/               @P0 BRA `(.L_x_3) ;                   /* 0xfffffffc00f40947 */
                                                                    /* 0x{w2:016x} */
        /*0030*/                   EXIT ;                            /* 0x000000000000794d */
                                                                    /* 0x000fea0003800000 */
"""


def test_loops_sum_the_stall_clocks_of_their_control_words():
    """Each instruction's stall (bits 41-44 of the control word on the line
    after it, beside the yield and barrier bits) adds to its loop's clocks."""
    other = (1 << 45) | (0x3F << 52) | 0x78e021c  # yield, wait mask, operand bits
    listing = STALL_LISTING.format(w0=other | 4 << 41, w1=other | 1 << 41, w2=5 << 41)
    (lp,) = sass.loops(listing, "mad_kernel")
    assert lp["n"] == 3 and lp["clocks"] == 10
    assert sass.loops(LISTING.format(target="0x20"), "chain_kernel")[0]["clocks"] == 0


# a compare kernel in two forms: the limb loads behind a branch on a loaded
# flag (two round trips in series), or every load issued first (one)
GATED_LISTING = """
        Function : cmp_kernel
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.U8 R2, [R4.64] ;
        /*0020*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0030*/              @!P0 BRA `(.L_x_1) ;
        /*0040*/                   LDG.E R6, [R8.64] ;
        /*0050*/                   LDG.E R7, [R8.64+0x10] ;
        /*0060*/                   IMAD.WIDE R10, R6, R7, RZ ;
        /*0070*/                   CALL.REL.NOINC `(.L_x_2) ;
.L_x_1:
        /*0080*/                   STG.E.U8 [R12.64], R2 ;
        /*0090*/                   EXIT ;
.L_x_2:
        /*00a0*/                   IMAD.WIDE R10, R10, R10, RZ ;
        /*00b0*/                   RET.REL.NODEC R2 0x0 ;
"""
FLAT_LISTING = """
        Function : cmp_kernel
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.U8 R2, [R4.64] ;
        /*0020*/                   LDG.E R6, [R8.64] ;
        /*0030*/                   LDG.E R7, [R8.64+0x10] ;
        /*0040*/                   IMAD.WIDE R10, R6, R7, RZ ;
        /*0050*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0060*/               @P0 STG.E.U8 [R12.64], R10 ;
        /*0070*/                   EXIT ;
"""


@pytest.mark.parametrize("listing,rounds,n,called",
                         [(GATED_LISTING, 2, 12, 2), (FLAT_LISTING, 1, 8, 0)])
def test_whole_counts_a_kernel_without_loops_and_its_loads_in_series(listing, rounds, n,
                                                                     called):
    """A kernel without loops as one block: every instruction (a CALL's
    callee to its RET too) and the global loads a thread waits for in
    series, a guarded branch on a loaded value putting every later load
    behind it."""
    assert sass.loops(listing, "cmp_kernel") == []
    w = sass.whole(listing, "cmp_kernel")
    assert (w["load_rounds"], w["n"], w["called"]) == (rounds, n, called)
    assert w["ops"]["LDG"] == 3


def test_main_whole_prints_the_kernel_as_one_block(monkeypatch, capsys):
    monkeypatch.setattr(sass, "dump", lambda so: GATED_LISTING)
    assert sass.main(["--whole", "lib.so", "cmp_kernel"]) == 0
    out = capsys.readouterr().out
    assert "lib.so cmp_kernel whole: 12 instructions (2 in called functions)" in out
    assert "global loads in series 2" in out
