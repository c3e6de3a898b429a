"""render_pixel_samples_per_s: pixel-samples of the renders completed in
the window over the window's seconds.  A render counts once its image is
on the host; the window ends with the first render that completes at or
after `--seconds`, so whole renders are counted over all the time they
took."""


def read(ctx):
    if ctx.cell.traffic["loop"] != "renders":
        return None
    return sum(u.pixel_samples for u in ctx.units) / ctx.window_s
