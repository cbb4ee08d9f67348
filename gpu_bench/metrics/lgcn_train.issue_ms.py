"""Mean host time to issue one LightGCN train step from an idle card: the
host clock around each of the steps that follow the window, each after a
synchronise, so that a full launch queue cannot make the host wait."""
import numpy as np


def read(record):
    issue = [(b - a) / 1e6 for n, a, b in record["spans"] if n == "issue"]
    return float(np.mean(issue)) if issue else None
