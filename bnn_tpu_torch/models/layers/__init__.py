from .common import conv1x1, conv3x3, make_activation
from .res_block import BasicBlock, Bottleneck, PreBasicBlock, PreBottleneck

__all__ = ["conv1x1", "conv3x3", "make_activation", "BasicBlock",
           "Bottleneck", "PreBasicBlock", "PreBottleneck"]
