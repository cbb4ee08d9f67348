"""Mean host time a ranking train step of the untraced window waited for its
batch: the host clock around ``next()`` on the prefetched batch stream
(``data/prefetch`` over the native sampler)."""
import numpy as np


def read(record):
    w = record["window"]
    waits = [(b - a) / 1e6 for n, a, b in record["spans"]
             if n == "sampler_wait" and w["t0_ns"] <= a < w["t1_ns"]]
    return float(np.mean(waits)) if waits else None
