"""grad_pixel_samples_per_s: lanes (one pixel-sample each) of the fwd+bwd
steps completed in the window, loss and gradients synchronised, over the
window's seconds."""


def read(ctx):
    if ctx.cell.traffic["loop"] != "grad_steps":
        return None
    return sum(u.pixel_samples for u in ctx.units) / ctx.window_s
