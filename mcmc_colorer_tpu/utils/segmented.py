"""Adaptive host driver for budgeted device-loop segments.

Every device-resident colorer loop (the device-side rendition of the
reference's host-free do-while, e.g. coloringMCMC_main.cu:160-269) is
compiled once with a *traced* iteration budget and driven from the host
in segments: run a budget of body iterations, read back two scalars,
adapt the next budget so each execution stays near ``target_s`` seconds.
The body sequence is identical to the monolithic loop, so results are
bit-equal to a single-execution run.

The segment boundaries are where the host sees the chain: checkpoint
writes (``--ckpt``), the interactive debugger (``--dbg``) and the
per-segment free-color TRACE lines all hook in through ``on_segment``.
"""

from __future__ import annotations

import time

# Wall-clock target per segment: how often the host hooks run.
SEGMENT_TARGET_S = 20.0
# The first segment is ONE iteration: it measures the per-iteration cost
# (and bears the compile) before the budget grows.
INIT_BUDGET = 1


def drive_segments(
    segment_fn,
    state,
    progress_fn,
    *,
    init_budget: int = INIT_BUDGET,
    target_s: float | None = None,
    grow: float = 8.0,
    on_segment=None,
):
    """Run ``segment_fn(state, budget) -> state`` until the loop reports
    completion.

    ``progress_fn(state) -> (steps_done_delta_capable_counter, done)``:
    reads back (with a host sync) the loop's iteration counter and a
    completion flag.  ``budget`` is passed as a plain int (the segment fn
    must treat it as traced — jit with it as an array argument — so one
    compiled program serves every segment).

    Budget adaptation: after each segment, scale the budget toward
    ``target_s`` seconds of wall per execution, growing at most ``grow``
    x per step (the first, compile-bearing segment cannot over-grow the
    second).

    ``on_segment(state, steps, budget, elapsed)`` is called after each
    segment (debug attach / checkpoint hooks).
    """
    if target_s is None:
        target_s = SEGMENT_TARGET_S  # module attr: patchable in tests
    budget = max(1, int(init_budget))
    prev_steps, done = progress_fn(state)
    while not done:
        t0 = time.perf_counter()
        state = segment_fn(state, budget)
        steps, done = progress_fn(state)  # host sync
        elapsed = time.perf_counter() - t0
        if on_segment is not None:
            on_segment(state, steps, budget, elapsed)
        executed = max(1, int(steps) - int(prev_steps))
        prev_steps = steps
        if executed < budget and not done:
            # the loop stopped early for its own reasons (e.g. converged
            # flag not yet surfaced); avoid a spin of empty segments
            break
        per = elapsed / executed
        budget = max(1, min(int(budget * grow), int(target_s / max(per, 1e-6))))
    return state
