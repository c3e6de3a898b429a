"""The pool's live lanes over its lanes, in %, mean over every poll of the
traced renders (RenderMetrics.bounce_alive: one reading a poll)."""


def read(ctx):
    polls = [n for u in ctx.traced_units if hasattr(u.counters, "bounce_alive")
             for n in u.counters.bounce_alive]
    lanes = ctx.sizes["lanes"]
    if not polls or not lanes:
        return None
    return 100.0 * sum(polls) / len(polls) / lanes
