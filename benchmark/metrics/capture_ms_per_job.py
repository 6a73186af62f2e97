"""Milliseconds a call spends capturing its step as a CUDA graph (capture
and warm-up step), as the program's fit logs them, over the window's
calls."""

import re

_LINE = re.compile(r"captured the train step as a CUDA graph in "
                   r"([0-9.]+)s \(warm-up step ([0-9.]+)s\)")


def read(ctx):
    per_call = []
    for c in ctx.calls:
        found = [_LINE.search(m) for m in c["logs"]]
        per_call.append(sum(float(f.group(1)) + float(f.group(2))
                            for f in found if f))
    if not per_call or not any(per_call):
        return None
    return 1e3 * sum(per_call) / len(per_call)
