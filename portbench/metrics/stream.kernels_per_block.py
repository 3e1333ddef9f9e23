"""Kernel nodes of the captured block graph, counted from its DOT dump
(cudaGraphDebugDotPrint) as chip_smoke.dot_nodes counts them."""

import re


def read(ctx):
    path = ctx.facts.get("graph_dot")
    if not path:
        return None
    with open(path) as f:
        text = f.read()
    starts = [m.start() for m in re.finditer(
        r'^\s*"graph_\d+_node_\d+"\s*\[', text, re.M)]
    n = 0
    for a, b in zip(starts, starts[1:] + [len(text)]):
        m = re.search(r'label="[{\s]*([A-Z_]+)', text[a:b])
        n += bool(m and m.group(1) == "KERNEL")
    return n or None
