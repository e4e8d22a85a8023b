"""``paddle.vision.models`` (counterpart of ``paddle_tpu/vision/models``):
every constructor the reference exports. Each model takes the
reference's arguments, then the port's keyword-only ``device`` (default
CUDA, raising without one) and ``dtype``; ``pretrained=True`` raises."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, resnext101_64x4d,
                     resnext152_32x4d, wide_resnet50_2, wide_resnet101_2)
from .lenet import LeNet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)

__all__ = ["AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet",
           "GoogLeNet", "InceptionV3", "LeNet", "MobileNetV1",
           "MobileNetV2", "MobileNetV3Large", "MobileNetV3Small", "ResNet",
           "ShuffleNetV2", "SqueezeNet", "VGG", "alexnet", "densenet121",
           "densenet161", "densenet169", "densenet201", "densenet264",
           "googlenet", "inception_v3", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_large", "mobilenet_v3_small", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "shufflenet_v2_swish", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg13", "vgg16",
           "vgg19", "wide_resnet50_2", "wide_resnet101_2"]
