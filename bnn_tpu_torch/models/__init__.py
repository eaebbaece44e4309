from .layers import BasicBlock, Bottleneck, PreBasicBlock, PreBottleneck
from .resnet import DaBNNStem, ResNet, resnet18, resnet34, resnet50
from .bats import (BATS_EXAMPLE, AuxiliaryHead, BATSNetworkCIFAR,
                   BATSNetworkImageNet, Cell)
from . import layers

__all__ = ["DaBNNStem", "ResNet", "resnet18", "resnet34", "resnet50",
           "BATS_EXAMPLE", "AuxiliaryHead", "BATSNetworkCIFAR",
           "BATSNetworkImageNet", "Cell", "layers", "BasicBlock",
           "Bottleneck", "PreBasicBlock", "PreBottleneck"]
