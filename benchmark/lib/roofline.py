"""A kernel's share of its roofline from the traced span."""

import re

from lib import workmodel


def kernel_seconds(span, names) -> float:
    """Device seconds of the operations named by any of ``names`` (as a
    whole word of the traced name)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(e - s for n, s, e in span.device_ops if pat.search(n)) * 1e-9


def share(ctx, kind: str, names) -> float:
    """100 x bound / device time per image-iteration, or None where the
    span ran none of the kernel."""
    span = ctx.span
    if span is None or not span.units:
        return None
    sec = kernel_seconds(span, names)
    if sec <= 0:
        return None
    works = ctx.work()
    bound = sum(workmodel.bound_s(kind, w, px, n)
                for w, px, n in works) / len(works)
    return 100.0 * bound / (sec / span.units)
