"""FFDNet's floating-point operations per call, from the layer shapes.

A call on ``N`` frames of ``H x W``: the input is padded to even size and
pixel-unshuffled to ``4 C + 1`` channels (the noise map appended) at
``H/2 x W/2``, then ``nb`` 3x3 convolutions: ``4C+1 -> nc``, ``nb - 2`` times
``nc -> nc``, ``nc -> 4C``. A convolution costs ``2 * 9 * Cin * Cout`` per
output pixel (a multiply and an add per weight); biases and ReLUs are not
counted, as a FLOP counter of convolutions does not count them.
"""


def flops_per_call(n: int, h: int, w: int, in_nc: int = 3, nc: int = 96, nb: int = 12,
                   out_nc: int = 3) -> int:
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    cins = [4 * in_nc + 1] + [nc] * (nb - 1)
    couts = [nc] * (nb - 1) + [4 * out_nc]
    return sum(2 * 9 * ci * co for ci, co in zip(cins, couts)) * n * h2 * w2
