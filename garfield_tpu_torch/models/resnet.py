"""CIFAR-style ResNet family (counterpart of ``garfield_tpu/models/resnet.py``):
3x3 stem without max-pool, ``BasicBlock`` for 18/34, ``Bottleneck`` for
50/101/152. Modules take NCHW tensors; see ``_layers`` for the flax
semantics they keep."""

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv, Dense

__all__ = [
    "BasicBlock", "Bottleneck", "ResNet",
    "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features, features, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.shortcut_conv = self.shortcut_bn = None
        if stride != 1 or in_features != features:
            self.shortcut_conv = Conv(in_features, features, 1, stride,
                                      dtype=dtype)
            self.shortcut_bn = BatchNorm(features, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features, features, stride=1, dtype=torch.float32):
        super().__init__()
        wide = features * 4
        self.conv1 = Conv(in_features, features, 1, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = Conv(features, wide, 1, dtype=dtype)
        self.bn3 = BatchNorm(wide, dtype=dtype)
        self.shortcut_conv = self.shortcut_bn = None
        if stride != 1 or in_features != wide:
            self.shortcut_conv = Conv(in_features, wide, 1, stride, dtype=dtype)
            self.shortcut_bn = BatchNorm(wide, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    """``ResNet(block, stage_sizes, num_classes, dtype, in_channels)``: NCHW
    images in, ``num_classes`` logits out (in ``dtype``)."""

    def __init__(self, block, stage_sizes, num_classes=10,
                 dtype=torch.float32, in_channels=3):
        super().__init__()
        self.block, self.stage_sizes = block, tuple(stage_sizes)
        self.num_classes, self.dtype = num_classes, dtype
        self.stem_conv = Conv(in_channels, 64, 3, 1, 1, dtype=dtype)
        self.stem_bn = BatchNorm(64, dtype=dtype)
        blocks, width = [], 64
        for stage, nblocks in enumerate(self.stage_sizes):
            for i in range(nblocks):
                stride = 2 if stage > 0 and i == 0 else 1
                features = 64 * 2 ** stage
                blocks.append(block(width, features, stride, dtype=dtype))
                width = features * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(width, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for blk in self.blocks:
            x = blk(x)
        return self.fc(x.mean((2, 3)))


def ResNet18(num_classes=10, dtype=torch.float32, in_channels=3):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype, in_channels)


def ResNet34(num_classes=10, dtype=torch.float32, in_channels=3):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, dtype, in_channels)


def ResNet50(num_classes=10, dtype=torch.float32, in_channels=3):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, dtype, in_channels)


def ResNet101(num_classes=10, dtype=torch.float32, in_channels=3):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, dtype, in_channels)


def ResNet152(num_classes=10, dtype=torch.float32, in_channels=3):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, dtype, in_channels)
