"""ResNet for ImageNet and CIFAR (the ResNet-50 training step is
bench.py's `build_resnet50_bench`).

Built from layers.conv2d, batch_norm and pool2d as the JAX package
builds it, so the two packages produce the same programs. On the card
the convolutions run on cuDNN; bf16 comes through the AMP decorator
(contrib/mixed_precision), which keeps batch norm and the loss in
float32.
"""
from __future__ import annotations

from .. import layers

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, groups=1):
    conv = layers.conv2d(x, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _shortcut(x, num_filters, stride):
    if x.shape[1] != num_filters or stride != 1:
        return _conv_bn(x, num_filters, 1, stride)
    return x


def _bottleneck(x, num_filters, stride):
    conv0 = _conv_bn(x, num_filters, 1, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3, stride, act="relu")
    conv2 = _conv_bn(conv1, num_filters * 4, 1)
    short = _shortcut(x, num_filters * 4, stride)
    return layers.relu(layers.elementwise_add(short, conv2))


def _basic(x, num_filters, stride):
    conv0 = _conv_bn(x, num_filters, 3, stride, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3)
    short = _shortcut(x, num_filters, stride)
    return layers.relu(layers.elementwise_add(short, conv1))


def resnet(img, class_dim=1000, depth=50):
    block_fn_name, counts = _DEPTH_CFG[depth]
    block_fn = _bottleneck if block_fn_name == "bottleneck" else _basic
    x = _conv_bn(img, 64, 7, stride=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for stage, n in enumerate(counts):
        filters = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block_fn(x, filters, stride)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(x, size=class_dim)


def resnet50(img, class_dim=1000):
    return resnet(img, class_dim, depth=50)


def build_train(img_shape=(3, 224, 224), class_dim=1000, depth=50,
                lr=0.1, momentum=0.9, amp=False):
    """The training graph: returns (loss, acc, feeds). amp=True runs the
    convolutions and the head in bf16 through the mixed-precision
    rewrite (batch norm and the loss stay float32)."""
    from .. import optimizer as opt
    img = layers.data("image", shape=list(img_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    logits = resnet(img, class_dim, depth)
    loss = layers.mean(
        layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    opt_inst = opt.Momentum(lr, momentum)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, acc, [img, label]


def flops_per_image(depth=50, img_hw=224, class_dim=1000):
    """Operations of one forward image: 2 per multiply-add of every
    convolution and of the head, from the layer dims (bench.py's count:
    8.178 GFLOP for ResNet-50 at 224)."""
    block_fn_name, counts = _DEPTH_CFG[depth]
    total = 0
    hw = img_hw // 2  # stem conv stride 2
    total += 2 * (7 * 7 * 3) * 64 * hw * hw
    hw //= 2  # maxpool stride 2
    c_in = 64
    for stage, n in enumerate(counts):
        filters = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            out_hw = hw // stride
            if block_fn_name == "bottleneck":
                total += 2 * (1 * 1 * c_in) * filters * hw * hw
                total += 2 * (3 * 3 * filters) * filters * out_hw * out_hw
                total += 2 * (1 * 1 * filters) * (filters * 4) * \
                    out_hw * out_hw
                if c_in != filters * 4 or stride != 1:
                    total += 2 * (1 * 1 * c_in) * (filters * 4) * \
                        out_hw * out_hw
                c_in = filters * 4
            else:
                total += 2 * (3 * 3 * c_in) * filters * out_hw * out_hw
                total += 2 * (3 * 3 * filters) * filters * \
                    out_hw * out_hw
                if c_in != filters or stride != 1:
                    total += 2 * (1 * 1 * c_in) * filters * \
                        out_hw * out_hw
                c_in = filters
            hw = out_hw
    total += 2 * c_in * class_dim  # head fc
    return total
