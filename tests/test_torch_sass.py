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
