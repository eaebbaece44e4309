"""The toy family's model, put into ``bnn_tpu_torch.models`` by
``drive.py``: a float stem conv, then ``features`` (binary-to-be conv, norm,
PReLU per layer), then a global average pool and the float head."""
import torch.nn.functional as F
from torch import nn


class TinyBNN(nn.Module):
    def __init__(self, num_classes: int = 10, channels=(16, 32, 32), strides=(2, 2, 1)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, channels[0], 3, strides[0], 1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels[0])
        layers = []
        for cin, cout, s in zip(channels, channels[1:], strides[1:]):
            layers += [nn.Conv2d(cin, cout, 3, s, 1, bias=False), nn.BatchNorm2d(cout),
                       nn.PReLU(cout)]
        self.features = nn.Sequential(*layers)
        self.fc = nn.Linear(channels[-1], num_classes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        return self.fc(self.features(h).mean(dim=(2, 3)))
