"""Bucket ladders: a copy of ``suggest_buckets`` from
``paddle_tpu/analysis/lint.py`` (the rest of the linter comes with a
later slice)."""


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _ladder(sizes, max_buckets):
    """Ascending power-of-two ladder covering [min(sizes), max(sizes)],
    at most ``max_buckets`` rungs. When thinning is needed the SMALL
    rungs are dropped: a small request padding up a level wastes a
    little compute; a missing top rung would be another program."""
    lo, hi = min(sizes), max(sizes)
    if lo < 1 or hi < 1:
        raise ValueError("bucket sizes must be positive, got %r"
                         % sorted(set(sizes))[:8])
    rungs = []
    p = _pow2_at_least(lo)
    while p < hi:
        rungs.append(p)
        p *= 2
    rungs.append(_pow2_at_least(hi))
    if len(rungs) > max_buckets:
        rungs = rungs[-max_buckets:]
    return tuple(rungs)


def suggest_buckets(observed, max_buckets=4):
    """Distill the sizes a workload sees into the bucket ladder that
    bounds its program count. ``observed`` is an iterable of ints (one
    dynamic dim), an iterable of same-rank shape tuples (a per-dim
    ladder each), or a dict of either. A request of size ``s`` resolves
    to the smallest rung ``>= s``."""
    if isinstance(observed, dict):
        return {k: suggest_buckets(v, max_buckets)
                for k, v in observed.items()}
    vals = list(observed)
    if not vals:
        raise ValueError("suggest_buckets: no observed shapes")
    if all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
        return _ladder(vals, max_buckets)
    shapes = [tuple(int(d) for d in s) for s in vals]
    if len({len(s) for s in shapes}) != 1:
        raise ValueError(
            "suggest_buckets: mixed ranks %s — one var's shapes only"
            % sorted({len(s) for s in shapes}))
    return tuple(
        (dim_vals[0],) if len(set(dim_vals)) == 1
        else _ladder(dim_vals, max_buckets)
        for dim_vals in zip(*shapes))
