"""Vision model zoo — counterpart of ``paddle_tpu/vision/models.py``
(python/paddle/vision/models/ in Paddle).

ResNet (BasicBlock / BottleneckBlock; ``resnet50`` is the ResNet-50 of
the repository's benchmark), VGG, LeNet, AlexNet and MobileNetV3 (the
detector's backbone), built from the port's layers with the reference's
sublayer names, so ``set_state_dict(state_dict_from_jax(jax_net))``
loads a whole net. NCHW by default (``nn.ChannelsLast`` wraps any of
them). ``pretrained=True`` raises: no weights are downloaded.
"""

from __future__ import annotations

from typing import List, Type, Union

from ..nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                  MaxPool2D, ReLU, Sequential)
from ..nn.layer import Layer

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "VGG", "vgg11", "vgg13",
           "vgg16", "vgg19", "LeNet"]


def _no_pretrained(flag):
    if flag:
        raise RuntimeError(
            "pretrained=True needs weight downloads, which this package "
            "does not do — load local weights with "
            "model.set_state_dict(paddle.load(path)) instead")


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
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

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, bias_attr=False)
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
    """ref: vision.models.ResNet (depth via block/layers lists)."""

    def __init__(self, block: Type[Union[BasicBlock, BottleneckBlock]],
                 depth_or_layers, num_classes: int = 1000,
                 with_pool: bool = True, groups: int = 1,
                 width: int = 64):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = (layer_cfg[depth_or_layers]
                  if isinstance(depth_or_layers, int) else list(depth_or_layers))
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False)
        self.bn1 = BatchNorm2D(self.inplanes)
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

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            from ..ops.manipulation import flatten
            x = self.fc(flatten(x, 1))
        return x


def _resnet(block, depth, pretrained, **kwargs):
    _no_pretrained(pretrained)
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


class VGG(Layer):
    """ref: vision.models.VGG (features + 4096-wide classifier head)."""

    def __init__(self, features: Layer, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                Linear(4096, 4096), ReLU(), Dropout(),
                Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            from ..ops.manipulation import flatten
            x = self.classifier(flatten(x, 1))
        return x


_VGG_CFG = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm=False):
    layers: List[Layer] = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


def _vgg(depth, pretrained, batch_norm=False, **kwargs):
    _no_pretrained(pretrained)
    return VGG(_vgg_features(_VGG_CFG[depth], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(11, pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(13, pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(16, pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(19, pretrained, batch_norm, **kwargs)


class LeNet(Layer):
    """ref: vision.models.LeNet (MNIST-scale smoke model)."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120), Linear(120, 84), Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            from ..ops.manipulation import flatten
            x = self.fc(flatten(x, 1))
        return x


# ---------------------------------------------------------------------------
# MobileNetV3 (ref: vision.models.MobileNetV3Small/Large — the backbone the
# detection family rides on; PP-LCNet/PP-YOLOE ecosystem target)
# ---------------------------------------------------------------------------

from ..nn import Hardsigmoid, Hardswish, Identity  # noqa: E402


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNLayer(Layer):
    def __init__(self, cin, cout, k, stride=1, groups=1, act=None):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride,
                           padding=(k - 1) // 2, groups=groups,
                           bias_attr=False)
        self.bn = BatchNorm2D(cout)
        self.act = ({"relu": ReLU, "hardswish": Hardswish}.get(act) or
                    Identity)()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class SEModule(Layer):
    def __init__(self, channel, reduction=4):
        super().__init__()
        self.avg_pool = AdaptiveAvgPool2D(1)
        self.conv1 = Conv2D(channel, channel // reduction, 1)
        self.relu = ReLU()
        self.conv2 = Conv2D(channel // reduction, channel, 1)
        self.hs = Hardsigmoid()

    def forward(self, x):
        s = self.hs(self.conv2(self.relu(self.conv1(self.avg_pool(x)))))
        return x * s


class InvertedResidual(Layer):
    def __init__(self, cin, mid, cout, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        self.expand = (ConvBNLayer(cin, mid, 1, act=act)
                       if mid != cin else Identity())
        self.dw = ConvBNLayer(mid, mid, k, stride=stride, groups=mid,
                              act=act)
        self.se = SEModule(mid) if use_se else Identity()
        self.pw = ConvBNLayer(mid, cout, 1, act=None)

    def forward(self, x):
        y = self.pw(self.se(self.dw(self.expand(x))))
        return x + y if self.use_res else y


# (kernel, exp, out, se, act, stride) per block — the reference configs
_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]
_MBV3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class MobileNetV3(Layer):
    """ref: vision.models.MobileNetV3Small/Large. ``feature_only=True``
    returns the three detection-scale feature maps (stride 8/16/32) for
    FPN necks (vision/detection.py)."""

    def __init__(self, config, last_channels, scale=1.0,
                 num_classes=1000, feature_only=False):
        super().__init__()
        self.feature_only = feature_only
        self.num_classes = num_classes
        cin = _make_divisible(16 * scale)
        self.stem = ConvBNLayer(3, cin, 3, stride=2, act="hardswish")
        blocks = []
        self._feat_idx = []
        strides_seen = 2
        for i, (k, exp, cout, se, act, stride) in enumerate(config):
            mid = _make_divisible(exp * scale)
            co = _make_divisible(cout * scale)
            blocks.append(InvertedResidual(cin, mid, co, k, stride, se, act))
            cin = co
            strides_seen *= stride
            # record the LAST block of each stride level (C3/C4/C5)
        self.blocks = Sequential(*blocks)
        self._config = config
        self._scale = scale
        self.out_channels = cin
        if not feature_only:
            mid = _make_divisible(last_channels * scale)
            self.last_conv = ConvBNLayer(cin, mid, 1, act="hardswish")
            self.pool = AdaptiveAvgPool2D(1)
            self.fc = Linear(mid, num_classes)

    def _feature_cuts(self):
        """Indices after which stride increases (C3=stride8 ... C5=32)."""
        cuts = []
        stride = 2  # stem
        for i, (_, _, _, _, _, s) in enumerate(self._config):
            if s == 2:
                stride *= s
                if stride in (16, 32):  # the block BEFORE this one closes
                    cuts.append(i - 1)  # the previous level
        cuts.append(len(self._config) - 1)
        return cuts[-3:]

    def forward(self, x):
        x = self.stem(x)
        if not self.feature_only:
            x = self.blocks(x)
            x = self.last_conv(x)
            x = self.pool(x)
            from ..ops.manipulation import flatten
            return self.fc(flatten(x, 1))
        feats = []
        cuts = set(self._feature_cuts())
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cuts:
                feats.append(x)
        return feats


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3(_MBV3_SMALL, 1024, scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3(_MBV3_LARGE, 1280, scale=scale, **kwargs)


class AlexNet(Layer):
    """ref: vision.models.AlexNet."""

    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(), MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2), ReLU(), MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(), MaxPool2D(3, 2))
        self.pool = AdaptiveAvgPool2D(6)
        self.classifier = Sequential(
            Dropout(dropout), Linear(256 * 36, 4096), ReLU(),
            Dropout(dropout), Linear(4096, 4096), ReLU(),
            Linear(4096, num_classes))

    def forward(self, x):
        x = self.pool(self.features(x))
        from ..ops.manipulation import flatten
        return self.classifier(flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


__all__ += ["MobileNetV3", "mobilenet_v3_small", "mobilenet_v3_large",
            "AlexNet", "alexnet"]
