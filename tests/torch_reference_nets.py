"""Reference-layout torch nets: independent re-statements of the
reference PyTorch models (ResNet-50, VGG-16, AlexNet V2, MobileNet V1,
Inception V1 with its aux heads) whose state-dict keys are the
converters' input contract (``conv{2..5}x.{j}``, ``projection.0/1``,
``features.N``, ``inception_3a.branch1_conv1x1``, ``linear``, ...),
copied from ``tests/test_convert.py``. They import torch only, so that
``tests/test_torch_convert.py`` and ``chip_smoke.py`` (on the card's
machine, which has no JAX) share them.
"""

import torch
import torch.nn as tnn

class TorchBottleneck(tnn.Module):
    def __init__(self, cin, mid, cout, stride=1, downsample=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, mid, 1, stride, bias=False)
        self.bn1 = tnn.BatchNorm2d(mid)
        self.conv2 = tnn.Conv2d(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(mid)
        self.conv3 = tnn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(cout)
        self.relu = tnn.ReLU()
        self.downsample = downsample
        if downsample:
            self.projection = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout),
            )

    def forward(self, x):
        identity = self.projection(x) if self.downsample else x
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))
        return self.relu(x + identity)


class TorchResNet50(tnn.Module):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, 1)

        def stage(n, cin, mid, cout, stride):
            blocks = [TorchBottleneck(cin, mid, cout, stride, True)]
            blocks += [
                TorchBottleneck(cout, mid, cout) for _ in range(n - 1)
            ]
            return tnn.Sequential(*blocks)

        self.conv2x = stage(3, 64, 64, 256, 1)
        self.conv3x = stage(4, 256, 128, 512, 2)
        self.conv4x = stage(6, 512, 256, 1024, 2)
        self.conv5x = stage(3, 1024, 512, 2048, 2)
        self.avgpool = tnn.AdaptiveAvgPool2d((1, 1))
        self.linear = tnn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.conv5x(self.conv4x(self.conv3x(self.conv2x(x))))
        x = self.avgpool(x).flatten(1)
        return self.linear(x)


class TorchVGG16(tnn.Module):
    """Independent re-statement of the reference's VGG-16 topology
    (ref: VGG/pytorch/models/vgg16.py — config D, Sequential
    features/classifier), for converter logits-parity."""

    def __init__(self, num_classes=10):
        super().__init__()
        cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]
        layers, c_in = [], 3
        for v in cfg:
            if v == "M":
                layers.append(tnn.MaxPool2d(2, 2))
            else:
                layers += [tnn.Conv2d(c_in, v, 3, padding=1), tnn.ReLU()]
                c_in = v
        self.features = tnn.Sequential(*layers)
        self.classifier = tnn.Sequential(
            tnn.Linear(512 * 7 * 7, 4096), tnn.ReLU(),
            tnn.Linear(4096, 4096), tnn.ReLU(),
            tnn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.classifier(x)


class TorchAlexNetV2(tnn.Module):
    """Independent re-statement of the reference's AlexNet V2 topology
    (ref: AlexNet/pytorch/models/alexnet_v2.py — single column,
    64/192/384/384/256)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.features = tnn.Sequential(
            tnn.Conv2d(3, 64, 11, 4, padding=2), tnn.ReLU(),
            tnn.MaxPool2d(3, 2),
            tnn.Conv2d(64, 192, 5, padding=2), tnn.ReLU(),
            tnn.MaxPool2d(3, 2),
            tnn.Conv2d(192, 384, 3, padding=1), tnn.ReLU(),
            tnn.Conv2d(384, 384, 3, padding=1), tnn.ReLU(),
            tnn.Conv2d(384, 256, 3, padding=1), tnn.ReLU(),
            tnn.MaxPool2d(3, 2),
        )
        self.classifier = tnn.Sequential(
            tnn.Linear(256 * 6 * 6, 4096), tnn.ReLU(),
            tnn.Linear(4096, 4096), tnn.ReLU(),
            tnn.Linear(4096, num_classes),
        )

    def forward(self, x):
        return self.classifier(self.features(x).flatten(1))


class TorchDWSep(tnn.Module):
    """dw(conv/bn/relu) + pw(conv/bn/relu), reference child naming
    (ref: MobileNet/pytorch/models/mobilenet_v1.py:95-156)."""

    class _Branch(tnn.Module):
        def __init__(self, conv, ch):
            super().__init__()
            self.conv = conv
            self.bn = tnn.BatchNorm2d(ch)
            self.relu = tnn.ReLU()

        def forward(self, x):
            return self.relu(self.bn(self.conv(x)))

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dw = self._Branch(
            tnn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False), cin
        )
        self.pw = self._Branch(tnn.Conv2d(cin, cout, 1, bias=False), cout)

    def forward(self, x):
        return self.pw(self.dw(x))


class TorchMobileNetV1(tnn.Module):
    """State-dict-key twin of the reference net (features.0/1 stem,
    features.3..15 separable convs, linear head —
    ref: mobilenet_v1.py:27-87)."""

    def __init__(self, num_classes=1000):
        super().__init__()
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2), (512, 512, 1), (512, 512, 1),
               (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 1024, 2),
               (1024, 1024, 1)]
        self.features = tnn.Sequential(
            tnn.Conv2d(3, 32, 3, 2, 1, bias=False),
            tnn.BatchNorm2d(32),
            tnn.ReLU(),
            *[TorchDWSep(ci, co, s) for ci, co, s in cfg],
            tnn.AdaptiveAvgPool2d((1, 1)),
        )
        self.linear = tnn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.features(x)
        return self.linear(x.flatten(1))


class TorchBasicConv2d(tnn.Module):
    """conv+bias+relu (ref: inception_v1.py:193-200)."""

    def __init__(self, cin, cout, k, **kw):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, **kw)

    def forward(self, x):
        return torch.relu(self.conv(x))


class TorchInceptionModule(tnn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, cp):
        super().__init__()
        self.branch1_conv1x1 = TorchBasicConv2d(cin, c1, 1)
        self.branch2_conv1x1 = TorchBasicConv2d(cin, c3r, 1)
        self.branch2_conv3x3 = TorchBasicConv2d(c3r, c3, 3, padding=1)
        self.branch3_conv1x1 = TorchBasicConv2d(cin, c5r, 1)
        self.branch3_conv5x5 = TorchBasicConv2d(c5r, c5, 5, padding=2)
        self.branch4_maxpool = tnn.MaxPool2d(3, 1, padding=1)
        self.branch4_conv1x1 = TorchBasicConv2d(cin, cp, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1_conv1x1(x),
            self.branch2_conv3x3(self.branch2_conv1x1(x)),
            self.branch3_conv5x5(self.branch3_conv1x1(x)),
            self.branch4_conv1x1(self.branch4_maxpool(x)),
        ], dim=1)


class TorchAux(tnn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.features = tnn.Sequential(
            tnn.AvgPool2d(5, 3), TorchBasicConv2d(cin, 128, 1)
        )
        self.classifier = tnn.Sequential(
            tnn.Linear(4 * 4 * 128, 1024), tnn.ReLU(),
            tnn.Dropout(0.7), tnn.Linear(1024, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        return self.classifier(x.view(x.size(0), 4 * 4 * 128))


class TorchInceptionV1(tnn.Module):
    """Key-naming twin of the reference incl. aux heads and stem LRNs
    (ref: inception_v1.py:27-113)."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.conv7x7 = TorchBasicConv2d(3, 64, 7, stride=2, padding=3)
        self.maxpool1 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.lrn1 = tnn.LocalResponseNorm(64)
        self.conv1x1 = TorchBasicConv2d(64, 64, 1)
        self.conv3x3 = TorchBasicConv2d(64, 192, 3, padding=1)
        self.lrn2 = tnn.LocalResponseNorm(192)
        self.maxpool2 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.inception_3a = TorchInceptionModule(192, 64, 96, 128, 16, 32, 32)
        self.inception_3b = TorchInceptionModule(256, 128, 128, 192, 32, 96, 64)
        self.maxpool3 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.inception_4a = TorchInceptionModule(480, 192, 96, 208, 16, 48, 64)
        self.aux1 = TorchAux(512, num_classes)
        self.inception_4b = TorchInceptionModule(512, 160, 112, 224, 24, 64, 64)
        self.inception_4c = TorchInceptionModule(512, 128, 128, 256, 24, 64, 64)
        self.inception_4d = TorchInceptionModule(512, 112, 144, 288, 32, 64, 64)
        self.aux2 = TorchAux(528, num_classes)
        self.inception_4e = TorchInceptionModule(528, 256, 160, 320, 32, 128, 128)
        self.maxpool4 = tnn.MaxPool2d(3, 2, ceil_mode=True)
        self.inception_5a = TorchInceptionModule(832, 256, 160, 320, 32, 128, 128)
        self.inception_5b = TorchInceptionModule(832, 384, 192, 384, 48, 128, 128)
        self.avgpool = tnn.AdaptiveAvgPool2d((1, 1))
        self.linear = tnn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.lrn1(self.maxpool1(self.conv7x7(x)))
        x = self.maxpool2(self.lrn2(self.conv3x3(self.conv1x1(x))))
        x = self.inception_3b(self.inception_3a(x))
        x = self.maxpool3(x)
        x = self.inception_4a(x)
        x = self.inception_4d(self.inception_4c(self.inception_4b(x)))
        x = self.inception_4e(x)
        x = self.maxpool4(x)
        x = self.inception_5b(self.inception_5a(x))
        x = self.avgpool(x)
        return self.linear(x.flatten(1))


