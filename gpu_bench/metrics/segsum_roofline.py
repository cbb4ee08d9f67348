"""Kernel A's share of its roofline: the compulsory bytes and operations of
the traced window's propagations (``work.lightgcn_propagation`` from each
step's shapes, forward and backward) at the peaks, over the device time of
the kernels whose names match ``PATTERNS``, in %."""
from gpu_bench import work
from gpu_bench.trace import union_length

PATTERNS = ("segsum",)


def read(record):
    if not record["events"]:
        return None
    w = record["trace_window"]
    iv = [(a, b) for n, a, b in record["events"] if any(p in n.lower() for p in PATTERNS)]
    busy = union_length(iv, w["t0_ns"], w["t1_ns"])
    if not busy:
        return None
    need = sum(2 * work.seconds(work.lightgcn_propagation(s["edges"], s["users"], s["items"],
                                                          s["width"], s["hops"], s["gather"]))
               for s in record["trace_shapes"])
    return 100.0 * need / (busy / 1e9)
