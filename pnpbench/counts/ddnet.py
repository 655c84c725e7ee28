"""DDnet's floating-point operations and bytes per call, from the layer
shapes.

One U-Net (a ``DenBlock``) on ``N`` frame triplets of ``H x W`` (``H`` and
``W`` multiples of 4), with ``e`` channels a frame in and ``o`` out: the
grouped input conv (3 groups of ``e`` -> 30 channels), the fusion conv 90 ->
c0, a stride-2 conv c0 -> c1 and two c1 -> c1 convs at ``H/2``, a stride-2
conv c1 -> c2 and two c2 -> c2 convs at ``H/4``, two c2 -> c2 convs and the
conv c2 -> 4 c1 before the pixel shuffle at ``H/4``, two c1 -> c1 convs and
the conv c1 -> 4 c0 at ``H/2``, then the output block c0 -> c0 -> o at
``H``. A 3x3 conv costs ``2 * 9 * Cin/groups * Cout`` per output pixel.

A DDnet call on ``N`` windows of five frames: ``temp1`` (1 channel a frame,
3 out) on the 3 triplets of each window at ``H``, ``temp11`` (4 channels,
4 out) on the 3 triplets at ``H/2`` and its fusion block (4 -> 4 -> 3) on
each of the 3 upsampled outputs at ``H``, ``temp2`` (3 channels, 3 out) on
each window's 2 branches at ``H``. The elementwise work (the residuals, the
upsample, the mixing) is not counted.
"""

CHANNELS = (20, 40, 80)
INTERM = 30


def convs(h: int, w: int, each: int, out: int, chs: tuple[int, int, int] = CHANNELS,
          interm: int = INTERM) -> list[tuple[int, int, int, int, int]]:
    """Every 3x3 conv of one DenBlock as ``(Cin, Cout, groups, Hout, Wout)``."""
    c0, c1, c2 = chs
    h1, w1, h2, w2 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    return [
        (3 * each, 3 * interm, 3, h, w), (3 * interm, c0, 1, h, w),
        (c0, c1, 1, h1, w1), (c1, c1, 1, h1, w1), (c1, c1, 1, h1, w1),
        (c1, c2, 1, h2, w2), (c2, c2, 1, h2, w2), (c2, c2, 1, h2, w2),
        (c2, c2, 1, h2, w2), (c2, c2, 1, h2, w2), (c2, 4 * c1, 1, h2, w2),
        (c1, c1, 1, h1, w1), (c1, c1, 1, h1, w1), (c1, 4 * c0, 1, h1, w1),
        (c0, c0, 1, h, w), (c0, out, 1, h, w),
    ]


def window_convs(h: int, w: int, chs: tuple[int, int, int] = CHANNELS
                 ) -> list[tuple[int, int, int, int, int, int]]:
    """Every conv of a DDnet call on one window as ``(times, Cin, Cout,
    groups, Hout, Wout)``."""
    return ([(3, *c) for c in convs(h, w, 1, 3, chs)]
            + [(3, *c) for c in convs(h // 2, w // 2, 4, 4, chs)]
            + [(3, 4, 4, 1, h, w), (3, 4, 3, 1, h, w)]
            + [(2, *c) for c in convs(h, w, 3, 3, chs)])


def flops_per_window(h: int, w: int, chs: tuple[int, int, int] = CHANNELS) -> int:
    return sum(n * 2 * 9 * (ci // g) * co * ho * wo
               for n, ci, co, g, ho, wo in window_convs(h, w, chs))


def flops_per_call(n: int, h: int, w: int, chs: tuple[int, int, int] = CHANNELS) -> int:
    """A DDnet call on ``n`` windows of ``h x w``."""
    return n * flops_per_window(h, w, chs)


def parameters(chs: tuple[int, int, int] = CHANNELS) -> int:
    """The weights of the three U-Nets and the fusion block, and the 9 + 36
    + 6 of the ``weight_tensor_*``."""
    convs_ = convs(4, 4, 1, 3, chs) + convs(4, 4, 4, 4, chs) + convs(4, 4, 3, 3, chs)
    return (sum(9 * (ci // g) * co for ci, co, g, _, _ in convs_)
            + 9 * (4 * 4 + 4 * 3) + 9 + 36 + 6)


def bytes_per_call(n: int, h: int, w: int, chs: tuple[int, int, int] = CHANNELS) -> int:
    """The least a call moves: its ``n`` float32 windows of five sparse-RGB
    frames read, its ``n`` RGB frames written, its float32 weights read
    once."""
    return 4 * (n * 5 * h * w * 3 + n * h * w * 3 + parameters(chs))
