from .common import conv1x1, conv3x3, make_activation
from .res_block import BasicBlock, Bottleneck, PreBasicBlock, PreBottleneck
from .hierarchical_block import HBlock
from .bats_ops import (OPS, PRIMITIVES, DilConv, FactorizedConv,
                       FactorizedReduce, Genotype, ReLUConvBN, SepConv, Zero,
                       channel_shuffle, drop_path)

__all__ = ["conv1x1", "conv3x3", "make_activation", "BasicBlock",
           "Bottleneck", "PreBasicBlock", "PreBottleneck", "HBlock", "OPS",
           "PRIMITIVES", "DilConv", "FactorizedConv", "FactorizedReduce",
           "Genotype", "ReLUConvBN", "SepConv", "Zero", "channel_shuffle",
           "drop_path"]
