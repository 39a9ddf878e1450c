"""`tools/sass_diff.py` pairs each whole-row build of a row-tile kernel
(template argument kSeg = false) with the kernel of the same role from
before the tile split wide rows; the compiler itself runs only where the
CUDA toolkit is installed."""

import pytest

from lanedetection_end2end_tpu_torch.tools import sass_diff

NAMES = {
    # demangled (c++filt) -> short name -> its role in the older checkout
    "void (anonymous namespace)::encoder_fused_kernel<false>("
    "__nv_bfloat16 const*, int)": ("encoder_fused_kernel<false>",
                                   "encoder_fused_kernel"),
    "(anonymous namespace)::encoder_fused_kernel(__nv_bfloat16 const*, int)":
        ("encoder_fused_kernel", "encoder_fused_kernel"),
    "void (anonymous namespace)::nb1d_chain_kernel<128, false>("
    "__nv_bfloat16 const*, (anonymous namespace)::Dilations, int)":
        ("nb1d_chain_kernel<128, false>", "nb1d_chain_kernel<128>"),
    "void (anonymous namespace)::nb1d_pass_kernel<16>(nb1d::Pass)":
        ("nb1d_pass_kernel<16>", "nb1d_pass_kernel<16>"),
}


@pytest.mark.parametrize("demangled", sorted(NAMES))
def test_kernel_names_pair_with_their_role(demangled):
    short, role = NAMES[demangled]
    assert sass_diff._short(demangled) == short
    assert sass_diff.role(short) == role
