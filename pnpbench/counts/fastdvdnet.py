"""FastDVDnet's floating-point operations per call, from the layer shapes.

One DenBlock on ``N`` frame triplets of ``H x W`` (``H`` and ``W``
multiples of 4): the grouped input conv (3 groups of 4 -> 30 channels), the
fusion conv 90 -> c0, a stride-2 conv c0 -> c1 and a CvBlock (two c1 -> c1
convs) at ``H/2``, a stride-2 conv c1 -> c2 and a CvBlock at ``H/4``, a
CvBlock at ``H/4`` and the conv c2 -> 4 c1 before the pixel shuffle, a
CvBlock at ``H/2`` and the conv c1 -> 4 c0, then the output block c0 -> c0
-> 3 at ``H``. A 3x3 conv costs ``2 * 9 * Cin/groups * Cout`` per output
pixel. A circular sequence call (``seq_circular``) on B frames runs two
DenBlocks (``temp1``, ``temp2``) over B triplets each.
"""


def convs(h: int, w: int, chs: tuple[int, int, int] = (32, 64, 128), color: int = 3,
          interm: int = 30) -> list[tuple[int, int, int, int, int]]:
    """Every 3x3 conv of one DenBlock as ``(Cin, Cout, groups, Hout, Wout)``."""
    c0, c1, c2 = chs
    h1, w1, h2, w2 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    return [
        (3 * (color + 1), 3 * interm, 3, h, w), (3 * interm, c0, 1, h, w),
        (c0, c1, 1, h1, w1), (c1, c1, 1, h1, w1), (c1, c1, 1, h1, w1),
        (c1, c2, 1, h2, w2), (c2, c2, 1, h2, w2), (c2, c2, 1, h2, w2),
        (c2, c2, 1, h2, w2), (c2, c2, 1, h2, w2), (c2, 4 * c1, 1, h2, w2),
        (c1, c1, 1, h1, w1), (c1, c1, 1, h1, w1), (c1, 4 * c0, 1, h1, w1),
        (c0, c0, 1, h, w), (c0, color, 1, h, w),
    ]


def denblock_flops(n: int, h: int, w: int, chs: tuple[int, int, int] = (32, 64, 128),
                   interm: int = 30) -> int:
    return sum(2 * 9 * (ci // g) * co * ho * wo
               for ci, co, g, ho, wo in convs(h, w, chs, interm=interm)) * n


def flops_per_call(b: int, h: int, w: int, chs: tuple[int, int, int] = (32, 64, 128),
                   interm: int = 30) -> int:
    """A ``seq_circular`` call on ``b`` frames."""
    return 2 * denblock_flops(b, h, w, chs, interm)

