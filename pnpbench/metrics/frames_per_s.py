"""Frames reconstructed per second: B frames a snapshot, times the snapshots
completed in the window, over the window's seconds (from the first hand-over
to the last result on the host)."""


def read(ctx):
    if not ctx.completed:
        return None
    return ctx.cell.traffic["frames"] * ctx.completed / ctx.window_s
