"""paddle_tpu_torch's Hopper kernels on the card (marked `cuda`; they
skip where there is no CUDA device).

The repository's conftest imports JAX, which the card's machine does not
have, so run these there without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 300, 64), (12, 512, 32),
                                   (4, 256, 128), (2, 64, 64)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_matches_plain(causal, dtype, tol, shape):
    """Kernel vs plain version on the card; T < 128 routes to the plain
    version and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA only)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               for _ in range(3))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    ref = tfa.reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert tfa.flash_attention.launches == before + (shape[1] >= 128)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA only)")
    q = torch.zeros((2, 128, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, q, q)
    h = torch.zeros((2, 128, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_fwd(h, h, h)
