"""The groups of 32 slots the BVH8 walk (K1) tested at its leaf visits, in
% of the 4 a visit, over the traced renders: RenderMetrics.k1_groups_tested
over 4 x RenderMetrics.k1_leaf_visits (the kernel's own counts, added on the
card by one atomic a warp and read when the render's pool loop has ended).
The rest are the groups whose box the ray does not enter, skipped.  None
where the program has no such counter or the walk visited no leaf."""

GROUPS_A_VISIT = 4


def read(ctx):
    counters = [u.counters for u in ctx.traced_units
                if hasattr(u.counters, "k1_leaf_visits")]
    visits = sum(c.k1_leaf_visits for c in counters)
    if not visits:
        return None
    return 100.0 * sum(c.k1_groups_tested for c in counters) / (GROUPS_A_VISIT * visits)
