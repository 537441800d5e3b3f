"""ResNet-50 frame backbone (torchvision-shaped, NCHW) for the CARL models.

Counterpart of `video_rep_learning_tpu/models/resnet.py`. Parameter names
follow the reference checkpoint: the frozen trunk is an `nn.Sequential`
slice of torchvision resnet50's children (0 conv1, 1 bn1, 2 relu, 3 maxpool,
4 layer1, 5 layer2, 6 layer3, 7 layer4), and the finetuned tail is layer4
itself (LAYER 3) or `Sequential(layer3, layer4)` (LAYER 2). The JAX
package's space-to-depth stem (`VRL_S2D_STEM`) is a TPU layout trick and is
not carried over.
"""

from __future__ import annotations

from torch import nn

from .layers import BN_EPS, BatchNorm2d

# (planes, blocks, stride) of layer1..layer4
_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class Bottleneck(nn.Module):
    """1x1 (planes) -> 3x3/stride (planes) -> 1x1 (4 * planes), BN after each,
    ReLU, identity or 1x1/stride downsample shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            BatchNorm2d(out, eps=BN_EPS)) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetStage(nn.Sequential):
    """One torchvision `layerN`: a downsampling block, then identity blocks."""

    def __init__(self, index: int):
        planes, blocks, stride = _STAGES[index - 1]
        inplanes = 64 if index == 1 else _STAGES[index - 2][0] * 4
        super().__init__(
            Bottleneck(inplanes, planes, stride, downsample=True),
            *(Bottleneck(planes * 4, planes) for _ in range(1, blocks)))


class ResNet50Trunk(nn.Sequential):
    """Stem + layer1..layer`upto`. Always run with inference-mode BN: this is
    the frozen part."""

    def __init__(self, upto: int = 3):
        super().__init__(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            BatchNorm2d(64, eps=BN_EPS),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(3, stride=2, padding=1),
            *(ResNetStage(i) for i in range(1, upto + 1)))


class ResNet50Stages(nn.Sequential):
    """layer`start`..layer4, the finetuned tail. With one stage its children
    are that stage's blocks (the reference stores layer4 itself); with more,
    its children are the stages."""

    def __init__(self, start: int, end: int = 4):
        stages = [ResNetStage(i) for i in range(start, end + 1)]
        super().__init__(*(stages[0] if len(stages) == 1 else stages))
