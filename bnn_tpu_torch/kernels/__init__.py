from .gemm import binary_gemm, binary_gemm_reference
from .packing import pack_bits, packed_words, unpack_bits
from .stem import fused_stem, fused_stem_reference

__all__ = ["binary_gemm", "binary_gemm_reference", "pack_bits",
           "packed_words", "unpack_bits", "fused_stem",
           "fused_stem_reference"]
