"""`mfu.train`: the train step's share of the card's float32 peak, as %:
three times the operations of one image's forward (forward, and the
backward's two products; counted from the layer shapes, `posebench/flops.py`)
x images per second of the untraced window / 165 TFLOP/s (a float32-accurate
product as three TF32 products, the rate `flops.py` counts float32 at)."""

from posebench.flops import PEAK_F32_3XTF32


def read(counters, trace):
    return 100.0 * 3 * counters["network_flops_per_image"] * counters["images_per_s"] / PEAK_F32_3XTF32
