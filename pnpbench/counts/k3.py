"""Operations and bytes of one launch of K3, FastDVDnet's fused conv pair
(``csrc/convpair_wgmma.cu``, ``csrc/convpair.cu``), on ``(N, H, W, C)``
bf16 activations: two 3x3 convolutions C -> C at 2 operations per
multiply-add; the input read and the output written once in bf16, both
kernels in bf16, four float32 vectors of C (the folded scales and shifts)."""


def flops_per_launch(n: int, h: int, w: int, c: int) -> int:
    return 2 * 2 * 9 * c * c * n * h * w


def bytes_per_launch(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * h * w * c * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
