"""Mixed-precision op lists, the JAX package's unchanged. The
low-precision type is bfloat16: the tensor cores' fast input type on the
card, with float32's exponent range, so loss scaling stays off.
"""
from __future__ import annotations

# Ops that should run in bf16: the matrix-product family.
white_list = {
    "mul", "matmul", "matmul_v2", "conv2d", "conv3d", "depthwise_conv2d",
    "conv2d_transpose",
    # fused attention kernels: bf16 operands, all softmax and accumulation
    # math stays f32 inside the kernel
    "flash_attention", "ring_attention", "ulysses_attention",
}

# Ops that must stay fp32 for numerics: reductions into losses, norms.
black_list = {
    "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "mean", "reduce_mean", "reduce_sum", "layer_norm", "batch_norm",
    "instance_norm", "group_norm", "softmax", "log_softmax", "exp", "log",
    "sum", "squared_l2_norm", "sigmoid_cross_entropy_with_logits",
}

# Everything else ("gray"): runs in whatever dtype arrives.
gray_list = None


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
