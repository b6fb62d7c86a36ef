"""DeepLabv3+ semantic segmentation (Cityscapes): the dilated-conv
training workload (bench.py's `build_deeplab_bench`).

A ResNet-50 trunk at output stride 16 (stage 4 dilated 2x instead of
strided), ASPP with rates 6/12/18 and an image-pooling branch, the v3+
decoder with a stride-4 low-level skip, and per-pixel softmax cross
entropy. Built from the same layers as the JAX package builds it, so the
two packages produce the same programs. On the card the convolutions
(dilated ones too) run on cuDNN; bf16 comes through the AMP decorator,
which keeps batch norm and the loss in float32; the resizes and concats
are plain torch (ops/nn_ops.py, ops/math.py).
"""
from __future__ import annotations

from .. import layers


N_CLASSES = 19  # Cityscapes


def _conv_bn(x, filters, ksize, stride=1, dilation=1, act="relu"):
    pad = dilation * (ksize - 1) // 2
    conv = layers.conv2d(x, filters, ksize, stride=stride, padding=pad,
                         dilation=dilation, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _bottleneck(x, filters, stride=1, dilation=1):
    y = _conv_bn(x, filters, 1)
    y = _conv_bn(y, filters, 3, stride=stride, dilation=dilation)
    y = _conv_bn(y, filters * 4, 1, act=None)
    if x.shape[1] != filters * 4 or stride != 1:
        x = _conv_bn(x, filters * 4, 1, stride=stride, act=None)
    return layers.relu(layers.elementwise_add(x, y))


def backbone_os16(img):
    """ResNet-50 trunk at output stride 16.

    Returns (low_level [b,256,H/4,W/4], high_level [b,2048,H/16,W/16]).
    Stage 4 keeps stride 1 with dilation 2, which keeps the resolution.
    """
    x = _conv_bn(img, 64, 7, stride=2)                      # /2
    x = layers.pool2d(x, 3, pool_type="max", pool_stride=2,
                      pool_padding=1)                       # /4
    for i in range(3):
        x = _bottleneck(x, 64)
    low = x                                                 # 256 ch, /4
    x = _bottleneck(x, 128, stride=2)                       # /8
    for i in range(3):
        x = _bottleneck(x, 128)
    x = _bottleneck(x, 256, stride=2)                       # /16
    for i in range(5):
        x = _bottleneck(x, 256)
    x = _bottleneck(x, 512, dilation=2)                     # /16 dilated
    for i in range(2):
        x = _bottleneck(x, 512, dilation=2)
    return low, x


def aspp(x, out_ch=256, rates=(6, 12, 18)):
    """Atrous spatial pyramid pooling at OS16 rates."""
    h, w = x.shape[2], x.shape[3]
    branches = [_conv_bn(x, out_ch, 1)]
    for r in rates:
        branches.append(_conv_bn(x, out_ch, 3, dilation=r))
    # image-level pooling branch: global mean -> 1x1 conv -> upsample
    pooled = layers.reduce_mean(x, dim=[2, 3], keep_dim=True)
    pooled = _conv_bn(pooled, out_ch, 1)
    pooled = layers.resize_bilinear(pooled, out_shape=[h, w],
                                    align_corners=False, align_mode=0)
    branches.append(pooled)
    cat = layers.concat(branches, axis=1)
    return _conv_bn(cat, out_ch, 1)


def deeplabv3p(img, n_classes=N_CLASSES):
    """img [b, 3, H, W] (H, W multiples of 16) -> logits [b, C, H, W]."""
    low, high = backbone_os16(img)
    x = aspp(high)
    lh, lw = low.shape[2], low.shape[3]
    x = layers.resize_bilinear(x, out_shape=[lh, lw],
                               align_corners=False, align_mode=0)  # x4
    low = _conv_bn(low, 48, 1)       # thin the skip (v3+ decoder recipe)
    x = layers.concat([x, low], axis=1)
    x = _conv_bn(x, 256, 3)
    x = _conv_bn(x, 256, 3)
    logits = layers.conv2d(x, n_classes, 1)
    return layers.resize_bilinear(logits,
                                  out_shape=[img.shape[2], img.shape[3]],
                                  align_corners=False, align_mode=0)


def build_train(img_hw=513, batch=8, n_classes=N_CLASSES, lr=1e-3,
                amp=False):
    """Per-pixel CE training step; returns (loss, [image, label]).

    513 is the canonical DeepLab crop (16k + 1); any multiple-of-16 +- 1
    works. Labels are int64 [b, H, W].
    """
    from .. import optimizer as opt

    # round the crop up so /16 is exact (513 -> 528 would distort the
    # canonical crop; instead keep 513 and let resize handle odd dims)
    img = layers.data("image", shape=[batch, 3, img_hw, img_hw],
                      dtype="float32", append_batch_size=False)
    label = layers.data("label", shape=[batch, img_hw, img_hw],
                        dtype="int64", append_batch_size=False)
    logits = deeplabv3p(img, n_classes)
    # [b, C, H, W] -> [b*H*W, C] for the shared CE op
    lt = layers.transpose(logits, [0, 2, 3, 1])
    lt = layers.reshape(lt, [-1, n_classes])
    lab = layers.reshape(label, [-1, 1])
    loss = layers.mean(layers.softmax_with_cross_entropy(lt, lab))
    opt_inst = opt.Momentum(learning_rate=lr, momentum=0.9)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, [img, label]


def flops_per_image(img_hw=513):
    """Approximate matmul-equivalent flops per image, one forward pass.
    Computed analytically per conv: 2 * Cin * Cout * K^2 * Hout * Wout.
    Backbone ~= ResNet-50 at OS16 (stage-4 spatial 4x larger than the
    strided net) + ASPP + decoder."""
    f = 0.0
    h = img_hw

    def conv(cin, cout, k, hout):
        return 2.0 * cin * cout * k * k * hout * hout

    h2, h4, h8, h16 = h // 2, h // 4, h // 8, h // 16
    f += conv(3, 64, 7, h2)
    # stage 1 (x3 bottleneck at /4)
    f += conv(64, 64, 1, h4) + conv(64, 64, 3, h4) + conv(64, 256, 1, h4)
    f += conv(64, 256, 1, h4)  # shortcut
    f += 2 * (conv(256, 64, 1, h4) + conv(64, 64, 3, h4)
              + conv(64, 256, 1, h4))
    # stage 2 (x4 at /8)
    f += conv(256, 128, 1, h8) + conv(128, 128, 3, h8) \
        + conv(128, 512, 1, h8) + conv(256, 512, 1, h8)
    f += 3 * (conv(512, 128, 1, h8) + conv(128, 128, 3, h8)
              + conv(128, 512, 1, h8))
    # stage 3 (x6 at /16)
    f += conv(512, 256, 1, h16) + conv(256, 256, 3, h16) \
        + conv(256, 1024, 1, h16) + conv(512, 1024, 1, h16)
    f += 5 * (conv(1024, 256, 1, h16) + conv(256, 256, 3, h16)
              + conv(256, 1024, 1, h16))
    # stage 4 dilated (x3 at /16)
    f += conv(1024, 512, 1, h16) + conv(512, 512, 3, h16) \
        + conv(512, 2048, 1, h16) + conv(1024, 2048, 1, h16)
    f += 2 * (conv(2048, 512, 1, h16) + conv(512, 512, 3, h16)
              + conv(512, 2048, 1, h16))
    # ASPP: 1x1 + 3 dilated 3x3 + pooled 1x1 + fuse 1x1 over 5*256 ch
    f += conv(2048, 256, 1, h16) + 3 * conv(2048, 256, 3, h16) \
        + 2 * 2048 * 256 + conv(5 * 256, 256, 1, h16)
    # decoder at /4
    f += conv(256, 48, 1, h4) + conv(304, 256, 3, h4) \
        + conv(256, 256, 3, h4) + conv(256, N_CLASSES, 1, h4)
    return f
