"""`pnp_ms.serve`: median ms a chunk in the Detector's `pnp` stage (one
padded PnP solve over every box of the chunk, on the host's clock of
`Detector._batch_finish`) over the window's chunks."""

import statistics


def read(counters, trace):
    values = counters["pnp_ms_per_chunk"]
    return statistics.median(values) if values else None
