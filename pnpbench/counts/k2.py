"""Bytes and operations of one launch of K2, the Chambolle TV prox
(``csrc/tv_chambolle.cu``), on ``planes`` float32 planes of ``h x w``: the
input read once and the output written once; 22 operations per pixel and
inner iteration (divergence 4, output 1, d^2 2, gradient 2, its norm 4 with
the square root, the coefficient 2, the dual update 6, the norm's sum 1),
for the iterations that the planes ran."""

FLOPS_PER_PIXEL_ITER = 22


def bytes_per_launch(planes: int, h: int, w: int) -> int:
    return 2 * planes * h * w * 4


def flops_per_launch(planes: int, h: int, w: int, iterations_per_plane: float) -> float:
    return iterations_per_plane * planes * h * w * FLOPS_PER_PIXEL_ITER
