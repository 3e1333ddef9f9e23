"""The yardstick of a kernel's roofline: the bytes the cell's graph needs
a segment to move, whatever implements it, over the card's published
HBM bandwidth."""

from __future__ import annotations

#: NVIDIA H100 SXM's published HBM3 bandwidth, bytes a second (at 700 W)
HBM_BYTES_PER_S = 3.35e12


def segment_bytes(cfg: dict, members) -> int:
    """Bytes a [batch, T] f32 render of one segment needs per sample of a
    stream: each signal it reads from outside read once, each of its
    signals read outside written once."""
    m = set(members)
    reads, writes = set(), set()
    for link in cfg["graph"]["links"]:
        src, dst = tuple(link["lhs"]), link["rhs"][0]
        if src[0] not in m and dst in m:
            reads.add(src)
        elif src[0] in m and dst not in m:
            writes.add(src)
    return 4 * (len(reads) + len(writes))


def roofline_pct(ctx, kernel: str):
    """The share of its bytes bound that ``kernel``'s launches reach in
    the traced window: the bound of the configuration's segments of that
    kernel for one unit over their summed device time a unit.  None where
    the cell has no such segment or the trace no such launch."""
    segs = ctx.cell.config.get("segments", {}).get(kernel)
    tr = ctx.trace
    if not segs or tr is None or tr.units == 0:
        return None
    runs = tr.kernels(lambda n: kernel in n and "reverse" not in n)
    if not runs:
        return None
    device_s = sum(b - a for _, a, b, _ in runs) / 1e6 / tr.units
    traffic = ctx.cell.traffic
    samples = (int(traffic["batch"])
               * round(traffic["seconds_per_stream"]
                       * ctx.cell.config["sample_rate"]))
    bound_s = sum(segment_bytes(ctx.cell.config, s) for s in segs) \
        * samples / HBM_BYTES_PER_S
    return 100.0 * bound_s / device_s
