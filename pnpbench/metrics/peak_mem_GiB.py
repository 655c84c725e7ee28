"""The device memory the program held at its peak in the window
(``torch.cuda.max_memory_allocated``, reset at the window's start), GiB."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 30
