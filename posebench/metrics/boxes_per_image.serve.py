"""`boxes_per_image.serve`: boxes that reached PnP (the Detector's results
after merge) per image, over the window."""


def read(counters, trace):
    return counters["boxes_per_image"]
