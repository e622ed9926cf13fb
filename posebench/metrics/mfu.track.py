"""`mfu.track`: the tracked frame's share of the card's float32 peak, as %:
operations of one frame's network (counted from the layer shapes,
`posebench/flops_track.py`) x frames per second of the untraced window /
165 TFLOP/s (a float32-accurate product as three TF32 products, the rate
`posebench/flops.py` counts float32 at)."""

from posebench.flops import PEAK_OF


def read(counters, trace):
    return 100.0 * counters["network_flops_per_image"] * counters["images_per_s"] / PEAK_OF["float32"]
