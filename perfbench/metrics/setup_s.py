"""setup_s: seconds from the process's start to the start of the first
timed unit: imports, the kernel build (the first run in a checkout),
the scene build, the graph captures and the warm-up units."""


def read(ctx):
    return ctx.setup_s
