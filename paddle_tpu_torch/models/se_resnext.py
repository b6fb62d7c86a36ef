"""SE-ResNeXt (the reference's test_parallel_executor_seresnext.py model,
book-style training): grouped 3x3 bottlenecks (cardinality) with
squeeze-and-excitation channel gates. Built as the JAX package builds
it, so the two packages produce the same programs; at its defaults it
is SE-ResNeXt-50 32x4d at ImageNet width. On the card the grouped
convolutions run on cuDNN.
"""
from __future__ import annotations

from .. import layers

__all__ = ["se_resnext", "build_train"]


def _conv_bn(x, ch, k, stride=1, groups=1, act="relu"):
    c = layers.conv2d(x, num_filters=ch, filter_size=k, stride=stride,
                      padding=(k - 1) // 2, groups=groups, act=None,
                      bias_attr=False)
    return layers.batch_norm(c, act=act)


def _squeeze_excitation(x, ch, reduction=16):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    sq = layers.fc(pool, size=max(ch // reduction, 4), act="relu")
    ex = layers.fc(sq, size=ch, act="sigmoid")
    ex = layers.unsqueeze(layers.unsqueeze(ex, [2]), [3])
    return layers.elementwise_mul(x, ex, axis=0)


def _block(x, ch, stride, cardinality, reduction):
    mid = ch // 2
    y = _conv_bn(x, mid, 1)
    y = _conv_bn(y, mid, 3, stride=stride, groups=cardinality)
    y = _conv_bn(y, ch, 1, act=None)
    y = _squeeze_excitation(y, ch, reduction)
    if x.shape[1] != ch or stride != 1:
        x = _conv_bn(x, ch, 1, stride=stride, act=None)
    return layers.relu(layers.elementwise_add(x, y))


def se_resnext(img, class_dim=1000, layers_per_stage=(3, 4, 6, 3),
               cardinality=32, reduction=16, base_ch=256):
    x = _conv_bn(img, 64, 7, stride=2)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    ch = base_ch
    for stage, n in enumerate(layers_per_stage):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            x = _block(x, ch, stride, cardinality, reduction)
        ch *= 2
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    return layers.fc(drop, size=class_dim, act="softmax")


def build_train(img_shape=(3, 224, 224), class_dim=1000, lr=0.1,
                layers_per_stage=(3, 4, 6, 3), cardinality=32,
                base_ch=256):
    img = layers.data("image", shape=list(img_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    pred = se_resnext(img, class_dim, layers_per_stage, cardinality,
                      base_ch=base_ch)
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(pred, label)
    from ..optimizer import MomentumOptimizer
    MomentumOptimizer(lr, momentum=0.9).minimize(loss)
    return loss, acc
