"""A closed loop of train steps: the target's ``step()`` is called back to
back until ``seconds`` have passed, then the card is synchronised; the
window runs from the first call to the end of that synchronise, so every
step counted has completed. Each call is a host span ``step``; each returns
the raw sizes of its step (``units`` among them), kept in the window's
``step_shapes``.

After the window, ``issue_probe_steps`` more steps each start from an idle
card (a synchronise before each): the host span ``issue`` around each is
the host's time to issue one step before the launch queue fills."""
from __future__ import annotations

import time


def run(target, mix: dict, seed: int, seconds: float, spans) -> dict:
    target.sync()
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    shapes = []
    while True:
        with spans.span("step"):
            shapes.append(target.step(spans))
        if time.perf_counter_ns() >= end:
            break
    with spans.span("sync"):
        target.sync()
    t1 = time.perf_counter_ns()
    for _ in range(int(mix.get("issue_probe_steps", 0))):
        target.sync()
        with spans.span("issue"):
            target.step(spans)
    target.sync()
    return {"t0_ns": t0, "t1_ns": t1, "attempted": len(shapes), "failed": 0,
            "steps": len(shapes), "units": sum(s["units"] for s in shapes),
            "step_shapes": shapes}
