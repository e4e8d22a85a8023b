"""ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``): the same layers, names
and ``state_dict`` keys, so ``convert.load_reference_state_dict``
carries the reference's weights across; built on the CPU from torch's
default generator, then moved to the keyword-only ``device`` (default
CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, BatchNorm2D, ReLU, MaxPool2D, Linear,
                   Sequential, AdaptiveAvgPool2D, Swish)
from ...ops.manipulation import concat, flatten, reshape, transpose, split

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = reshape(x, [b, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [b, c, h, w])


def _act(name):
    return Swish() if name == "swish" else ReLU()


class InvertedResidual(Layer):
    def __init__(self, cin, cout, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride > 1:
            self.branch1 = Sequential(
                Conv2D(cin, cin, 3, stride=stride, padding=1, groups=cin,
                       bias_attr=False),
                BatchNorm2D(cin),
                Conv2D(cin, branch, 1, bias_attr=False),
                BatchNorm2D(branch), _act(act))
            b2in = cin
        else:
            self.branch1 = None
            b2in = cin // 2
        self.branch2 = Sequential(
            Conv2D(b2in, branch, 1, bias_attr=False),
            BatchNorm2D(branch), _act(act),
            Conv2D(branch, branch, 3, stride=stride, padding=1,
                   groups=branch, bias_attr=False),
            BatchNorm2D(branch),
            Conv2D(branch, branch, 1, bias_attr=False),
            BatchNorm2D(branch), _act(act))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = split(x, 2, axis=1)
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        assert scale in _STAGE_OUT, f"supported scales: {sorted(_STAGE_OUT)}"
        ch = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = Sequential(
            Conv2D(3, ch[0], 3, stride=2, padding=1, bias_attr=False),
            BatchNorm2D(ch[0]), _act(act))
        self.max_pool = MaxPool2D(3, stride=2, padding=1)
        stages = []
        cin = ch[0]
        for i, repeats in enumerate([4, 8, 4]):
            cout = ch[i + 1]
            seq = [InvertedResidual(cin, cout, 2, act)]
            seq += [InvertedResidual(cout, cout, 1, act)
                    for _ in range(repeats - 1)]
            stages.append(Sequential(*seq))
            cin = cout
        self.stages = Sequential(*stages)
        self.conv_last = Sequential(
            Conv2D(cin, ch[-1], 1, bias_attr=False),
            BatchNorm2D(ch[-1]), _act(act))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(ch[-1], num_classes)
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.conv_last(self.stages(self.max_pool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _make(scale, act="relu", name=""):
    def ctor(pretrained=False, **kwargs):
        if pretrained:
            raise RuntimeError("pretrained weights are not available offline")
        return ShuffleNetV2(scale=scale, act=act, **kwargs)
    ctor.__name__ = name
    return ctor


shufflenet_v2_x0_25 = _make(0.25, name="shufflenet_v2_x0_25")
shufflenet_v2_x0_33 = _make(0.33, name="shufflenet_v2_x0_33")
shufflenet_v2_x0_5 = _make(0.5, name="shufflenet_v2_x0_5")
shufflenet_v2_x1_0 = _make(1.0, name="shufflenet_v2_x1_0")
shufflenet_v2_x1_5 = _make(1.5, name="shufflenet_v2_x1_5")
shufflenet_v2_x2_0 = _make(2.0, name="shufflenet_v2_x2_0")
shufflenet_v2_swish = _make(1.0, act="swish", name="shufflenet_v2_swish")
