"""`mfu.serve`: the served network's share of the card's bf16 peak, as %:
operations of one image's forward (counted from the layer shapes,
`posebench/flops.py`) x images per second of the untraced window / 989
TFLOP/s."""

from posebench.flops import PEAK_BF16


def read(counters, trace):
    return 100.0 * counters["network_flops_per_image"] * counters["images_per_s"] / PEAK_BF16
