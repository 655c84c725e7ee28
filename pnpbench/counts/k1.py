"""Bytes of one launch of K1, the fused x-update (``csrc/x_update.cu``), on a
packed cube of B frames of ``4 x H/2 x W/2`` float32 values with one mask
shared by ``items`` cubes: theta, b and the output per item and phi once
are cubes, y per item and the mask sum once are planes; each read or
written once."""


def bytes_per_launch(b: int, h: int, w: int, items: int = 1) -> int:
    cube, plane = b * h * w, h * w
    return ((3 * items + 1) * cube + (items + 1) * plane) * 4
