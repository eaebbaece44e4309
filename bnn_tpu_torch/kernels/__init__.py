from .block import fused_basic_block, fused_basic_block_reference
from .bottleneck import (BottleneckDesc, fused_bottleneck,
                         fused_bottleneck_reference)
from .conv import (binary_conv2d, binary_conv2d_reference, binary_conv2d_s1,
                   binary_conv2d_s1_reference)
from .gemm import (binary_gemm, binary_gemm_reference, popcount_gemm,
                   popcount_gemm_reference)
from .model import (BlockParams, fused_chain, fused_chain_reference,
                    fused_down_stage, fused_down_stage_reference, fused_pair,
                    fused_pair_reference, fused_stem_chain,
                    fused_stem_chain_reference)
from .packing import pack_bits, packed_words, unpack_bits
from .stem import (StemDesc, fused_stem, fused_stem_reference, fused_stem_v2,
                   fused_stem_v3)
from .strided_block import (fused_downsample_block,
                            fused_downsample_block_reference)
from . import ops  # registers the operators the wrappers above call

__all__ = ["binary_gemm", "binary_gemm_reference", "pack_bits",
           "packed_words", "unpack_bits", "fused_stem", "fused_stem_v2",
           "fused_stem_v3", "fused_stem_reference", "StemDesc",
           "fused_basic_block", "fused_basic_block_reference", "fused_downsample_block",
           "fused_downsample_block_reference", "BlockParams", "fused_chain",
           "fused_chain_reference", "fused_pair", "fused_pair_reference",
           "fused_down_stage", "fused_down_stage_reference", "BottleneckDesc",
           "fused_bottleneck", "fused_bottleneck_reference",
           "fused_stem_chain", "fused_stem_chain_reference",
           "binary_conv2d_s1", "binary_conv2d_s1_reference",
           "binary_conv2d", "binary_conv2d_reference",
           "popcount_gemm", "popcount_gemm_reference"]
