"""The epilogue kernel's wrapper (``ops/cuda_kernels.scale_shift_relu``) and
the route FastDVDnet takes to it, on the CPU.

A CPU tensor takes the plain version, bit for bit; the bf16 eval forward
without gradient calls the wrapper at each of its BatchNorm'd library
convolutions, and every other forward (with gradient, train mode, float32)
keeps PyTorch's passes. The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from adaptivepnp_sci_torch.models.fastdvdnet import FastDVDnet
from adaptivepnp_sci_torch.ops import convpair, cuda_kernels


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("c", [90, 32])
def test_wrapper_takes_cpu_tensors_to_the_plain_version(c, channels_last):
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(2, c, 5, 7, generator=g) * 3).to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    s, b = torch.randn(c, generator=g), torch.randn(c, generator=g)
    cuda_kernels.reset_launches()
    got = cuda_kernels.scale_shift_relu(x, s, b)
    want = convpair.scale_shift_relu(x, s, b)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert cuda_kernels.launches["bn_relu"] == 0


def _net(dtype):
    net = FastDVDnet(dtype=dtype, remat=False)
    g = torch.Generator().manual_seed(0)
    for m in net.modules():  # running statistics away from the identity
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return net.eval()


@pytest.mark.parametrize("case", ["bf16_no_grad", "bf16_grad", "bf16_train", "fp32_no_grad"])
def test_fastdvdnet_calls_the_kernel_wrapper_only_in_bf16_eval_without_gradient(
        monkeypatch, case):
    calls = []
    wrapper = cuda_kernels.scale_shift_relu

    def spy(x, s, b):
        calls.append(x.shape[1])
        return wrapper(x, s, b)

    monkeypatch.setattr(cuda_kernels, "scale_shift_relu", spy)
    net = _net(None if case == "fp32_no_grad" else torch.bfloat16)
    frames = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    if case == "bf16_train":
        net.train()
        net(torch.rand(2, 5, 16, 16, 3, generator=torch.Generator().manual_seed(2)), 0.05)
    elif case == "bf16_grad":
        net.seq_circular(frames, 0.05).square().mean().backward()
        assert all(p.grad is not None for p in net.parameters())
    else:
        with torch.no_grad():
            net.seq_circular(frames, 0.05)
    if case == "bf16_no_grad":
        # per DenBlock: inc's two convs (90, 32), the two downs' strided convs
        # (64, 128) and outc's first conv (32); temp1 and temp2
        assert calls == [90, 32, 64, 128, 32] * 2
    else:
        assert calls == []

