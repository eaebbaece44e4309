from .layers import BasicBlock, Bottleneck, PreBasicBlock, PreBottleneck
from .resnet import ResNet, resnet18, resnet34, resnet50

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "BasicBlock",
           "Bottleneck", "PreBasicBlock", "PreBottleneck"]
