"""One closed-loop client: it sends a request, waits for the answer as host
arrays, and sends the next, until ``seconds`` have passed (the request in
flight then finishes and counts).

Requests: every user of the target once a pass, in an order drawn from the
seed anew each pass, cut into requests of ``request_users`` (the last of a
pass holds the rest). So every seed sends the same sizes, in another order
of users. A request that raises counts as failed."""
from __future__ import annotations

import time

import numpy as np


def request_stream(mix: dict, seed: int, num_users: int):
    """Endless requests (arrays of user ids) drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    n = int(mix["request_users"])
    while True:
        order = rng.permutation(num_users)
        for s in range(0, num_users, n):
            yield order[s: s + n]


def run(target, mix: dict, seed: int, seconds: float, spans) -> dict:
    stream = request_stream(mix, seed, target.num_users())
    answers = []
    attempted = failed = answered = 0
    first_error = None
    target.sync()
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    while time.perf_counter_ns() < end:
        users = next(stream)
        attempted += 1
        try:
            with spans.span("request"):
                ans = target.request(users, spans)
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            failed += 1
            first_error = first_error or repr(e)
            continue
        answered += len(users)
        answers.append((users, ans))
    t1 = time.perf_counter_ns()
    return {"t0_ns": t0, "t1_ns": t1, "attempted": attempted, "failed": failed,
            "first_error": first_error, "users_answered": answered, "answers": answers}
