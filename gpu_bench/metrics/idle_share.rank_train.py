"""Share of the traced window in which no kernel, copy or set ran on the
device: one minus the union of the device's intervals over the window, in
%."""
from gpu_bench.trace import idle_share


def read(record):
    if not record["events"]:
        return None
    w = record["trace_window"]
    return idle_share([(a, b) for _, a, b in record["events"]], w["t0_ns"], w["t1_ns"])
