"""The LightGCN train step's share of the card's peaks: the compulsory work
of the untraced window's steps (``work.lightgcn_train_step`` from each
step's edges, tables, width, hops and batch: K-hop propagation forward and
backward, the BPR rows, Adam over both tables, each at its roofline) over
that window's wall time, in %."""
import sys

from gpu_bench import work


def step_work(s):
    return work.lightgcn_train_step(s["edges"], s["users"], s["items"], s["width"], s["hops"],
                                    s["batch"], s["gather"])


def read(record):
    shapes = record["shapes"]
    if not shapes:
        return None
    print("lgcn_train.mfu: bounds by operation: "
          + ", ".join(work.bound(w) for w in step_work(shapes[0])), file=sys.stderr)
    return 100.0 * sum(work.total_seconds(step_work(s)) for s in shapes) / record["window_s"]
