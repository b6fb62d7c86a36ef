"""paddle_tpu_torch's Hopper kernels (the flash-attention forward and
its two backward kernels), and the paged_attention op's CUDA run, on the
card (marked `cuda`; they skip where there is no CUDA device).

The repository's conftest imports JAX, which the card's machine does not
have, so run these there without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


def _diff_share(got, want):
    return (got.float() != want.float()).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 300, 64), (12, 512, 32),
                                   (4, 256, 128), (12, 1024, 64),
                                   (2, 64, 64), (384, 511, 64),
                                   (24, 129, 64), (24, 200, 64),
                                   (24, 255, 64), (8, 200, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_matches_plain(causal, dtype, shape):
    """Kernel vs its plain version on float32 copies of the inputs (the
    TPU kernel's float32 scores), in the input dtype: within 1e-4 in
    float32 (the 3xTF32 kernel: at most 4.4e-6 on the H100; one TF32
    product: 2.9e-4 to 1.5e-3); in bfloat16 a relative error within 1e-2
    with at most 60% of the elements differing (sound kernel: at most
    4.4e-3 and 0.396; keys past T unmasked: 2.4e-2 and 0.998). T < 128
    routes to the plain version itself and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA only)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               for _ in range(3))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert tfa.flash_attention.launches == before + (shape[1] >= 128)
    if shape[1] < 128:
        assert torch.equal(out, tfa.reference_attention(q, k, v,
                                                        causal=causal))
        return
    want = tfa.flash_attention_fwd_reference(
        q.float(), k.float(), v.float(), causal=causal)[0].to(dt)
    if dtype == "float32":
        assert (out - want).abs().max().item() <= 1e-4
    else:
        assert _rel(out, want) <= 1e-2 and _diff_share(out, want) <= 0.6


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d,causal", [
    (96, 512, 64, False), (96, 300, 64, False), (12, 1024, 64, True),
    (24, 512, 128, True)])
def test_float32_forward_kernel_meets_float32_limits(bh, t, d, causal):
    """The float32 forward (3xTF32 on the tensor cores) through its own
    wrapper against its plain version on the same inputs: O within 1e-4
    and LSE within 1e-3, at the serving shape, a ragged T, T 1024 causal
    (many tiles through the ring) and d 128 causal (on the H100 the
    kernel reads at most 4.4e-6 and 2.6e-6 over the chip check's cases;
    with one TF32 product instead of three, 2.9e-4 to 1.5e-3 and up to
    1.0e-3; with keys past T unmasked, 2.5e-2 and 5.9e-2 at T 300)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA only)")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda")
               for _ in range(3))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    want, want_lse = tfa.flash_attention_fwd_reference(q, k, v,
                                                       causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert (o - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-3


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


def _bwd_inputs(bh, t, d, dtype, causal):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn((bh, t, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d,dtype,causal", [
    (384, 512, 64, "bfloat16", False), (384, 512, 64, "float32", False),
    (384, 512, 64, "bfloat16", True), (96, 300, 64, "float32", True),
    (96, 300, 64, "bfloat16", False), (96, 300, 64, "bfloat16", True),
    (12, 1024, 64, "bfloat16", True), (24, 512, 128, "float32", False),
    (24, 512, 128, "bfloat16", False), (24, 512, 128, "bfloat16", True),
    (48, 512, 32, "float32", True), (48, 512, 32, "bfloat16", False),
    (12, 512, 64, "bfloat16", False), (96, 300, 64, "float32", False),
    (12, 1024, 64, "float32", True), (24, 512, 128, "float32", True),
    (12, 512, 64, "float32", False), (192, 512, 64, "float32", False),
    (48, 512, 32, "float32", False), (384, 511, 64, "bfloat16", True),
    (96, 129, 64, "bfloat16", False), (96, 129, 64, "bfloat16", True),
    (96, 200, 64, "bfloat16", False), (96, 200, 64, "bfloat16", True),
    (96, 255, 64, "bfloat16", False), (96, 255, 64, "bfloat16", True),
    (48, 255, 32, "bfloat16", True), (24, 200, 128, "bfloat16", True),
    (96, 129, 64, "float32", False), (96, 129, 64, "float32", True),
    (96, 200, 64, "float32", False), (96, 200, 64, "float32", True),
    (96, 255, 64, "float32", False), (96, 255, 64, "float32", True),
    (48, 255, 32, "float32", True), (24, 200, 128, "float32", True)])
def test_backward_kernels_match_plain(bh, t, d, dtype, causal):
    """dq and dk/dv kernels vs their plain versions, the chip phase's
    cases: max|kernel - plain| / max(1, max|plain|) within 5e-3 in
    bfloat16, where also at most 1% of the elements may differ at all
    (sound kernels: at most 2.8e-3 and 0.24%; one skipped bf16 rounding
    of P or dS: 3.6e-3 to 7.2e-3 and over 41%; dS from the rounded P: 2.7e-3
    to 1.0e-2 and over 51%); in float32 (3xTF32 on the tensor cores)
    within 1e-4 both over max(1, max|plain|) and absolute (the chip
    check's float32 cases read at most 8.0e-5 absolute; with one TF32
    product instead of three, 3.8e-4 to 3.9e-3). The float32 cases at T
    129, 200 and 255 and the ragged d 32 and d 128 ones sit at the edges
    of the float32 kernels' tiles (128-row query and key tiles, 64 at d
    128; 32-key and 16-query ring stages)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA only)")
    args = _bwd_inputs(bh, t, d, getattr(torch, dtype), causal)
    dq = tfa.flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(*args, causal=causal)
    rq = tfa.flash_attention_bwd_dq_reference(*args, causal=causal)
    rk, rv = tfa.flash_attention_bwd_dkv_reference(*args, causal=causal)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 5e-3
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == want.dtype and _rel(got, want) <= tol
        if dtype == "bfloat16":
            assert _diff_share(got, want) <= 1e-2
        else:
            assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_backward_through_function_launches_each_kernel_once():
    """loss.backward() through flash_attention: one forward launch, then
    one launch of each backward kernel; the gradients agree with the
    plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA only)")
    g = torch.Generator(device="cuda").manual_seed(2)
    leaves = [torch.randn((2, 3, 256, 64), generator=g, device="cuda")
              .requires_grad_() for _ in range(3)]
    counts = (tfa.flash_attention.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    out = tfa.flash_attention(*leaves, causal=True)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - counts[0],
            tfa.flash_attention_bwd_dq.launches - counts[1],
            tfa.flash_attention_bwd_dkv.launches - counts[2]) == (1, 1, 1)
    ref_leaves = [x.detach().clone().requires_grad_() for x in leaves]
    tfa.reference_attention(*ref_leaves, causal=True).square().sum() \
        .backward()
    for x, r in zip(leaves, ref_leaves):
        assert _rel(x.grad, r.grad) <= 1e-4


@pytest.mark.cuda
def test_paged_attention_on_the_card_matches_the_cpu():
    """The paged_attention op on CUDA tensors against the same op on the
    CPU: a muted row, a partly valid chunk and a full one, with several
    writes landing on the scratch block 0 (which of them lands is
    undefined on the card). Out at every valid position and every
    mapped pool block agree within 1e-5; garbage in block 0 changes
    neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.core.registry import REGISTRY
    g = torch.Generator().manual_seed(3)
    nb, bs, h, hd, b, t = 12, 4, 2, 8, 3, 4
    ins = {"Q": torch.randn(b, h, t, hd, generator=g),
           "K": torch.randn(b, h, t, hd, generator=g),
           "V": torch.randn(b, h, t, hd, generator=g),
           "CacheK": torch.randn(nb, bs, h, hd, generator=g),
           "CacheV": torch.randn(nb, bs, h, hd, generator=g),
           "BlockTable": torch.tensor([[0, 0, 0], [3, 7, 0], [1, 4, 9]]),
           "StartPos": torch.tensor([0, 5, 8]),
           "NValid": torch.tensor([0, 2, 4])}
    lower = REGISTRY.get("paged_attention").lower
    attrs = {"sm_scale": hd ** -0.5}

    def run(device, scratch):
        x = {k: v.clone().to(device) for k, v in ins.items()}
        x["CacheK"][0] = scratch
        x["CacheV"][0] = scratch
        ctx = lowering.LowerCtx(device)
        out = lower(lowering._OpCtx(ctx, _PagedOp(attrs)),
                    {k: [v] for k, v in x.items()}, attrs)
        return {k: v[0].cpu() for k, v in out.items()}

    cpu = run("cpu", 0.0)
    mapped = [1, 3, 4, 7, 9]
    for scratch in (0.0, 1e3):
        card = run("cuda", scratch)
        for row, n in enumerate(ins["NValid"].tolist()):
            assert torch.allclose(card["Out"][row, :, :n],
                                  cpu["Out"][row, :, :n], atol=1e-5, rtol=0)
        for slot in ("CacheKOut", "CacheVOut"):
            assert torch.equal(card[slot][mapped], cpu[slot][mapped])


class _PagedOp:
    """The program op a lowering's context reads (attrs, id)."""

    def __init__(self, attrs):
        self.attrs, self.id, self.block, self.type = attrs, 7, None, \
            "paged_attention"
        self.outputs = {}
