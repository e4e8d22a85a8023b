"""The ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``):
the same architecture, layer names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries a reference model's weights
and BatchNorm running stats across as they are.

``ResNet`` (and every constructor through ``**kwargs``) takes the port's
keyword-only ``device`` and ``dtype``: the model is built, drawn from
torch's default generator, then moved to ``device`` (default CUDA,
raising without one; ``device="cpu"`` for the CPU). ``pretrained=True``
raises: there are no weights to download.
"""
from __future__ import annotations

from ...framework import resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Layer, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn.functional import flatten

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=1, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None, dtype=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes)
        self.to(resolve_device(device), dtype)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError(
            "pretrained weights are not available offline; load a local "
            "state_dict via model.set_state_dict(paddle.load(path))")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 64
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
