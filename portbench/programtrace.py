"""The program's own trace, shared by the metric readers that read it:
the frame records that `pointclouds_tpu_torch.utils.profiling` keeps for
each pipeline call (spans and counters recorded inside the work).

`start()`, called by each such reader as it is loaded, switches the
program's tracing on and empties the window's list. Per-layer readers are
loaded only by ``--trace 1`` runs, so an untraced run, the one that is
timed, runs with tracing off. ``COUNTS`` puts one counter on each pipeline
entry: the harness wraps it around the window only, and after each call
the frame's record joins ``WINDOW``. The harness keeps one counter a key,
so every reader shares this one function. A program without tracing
records nothing, and every reader then returns None."""

from __future__ import annotations

from pointclouds_tpu_torch.utils import profiling

ENTRIES = (
    "pointclouds_tpu_torch.pipelines.kitti:kitti_obstacle_pipeline",
    "pointclouds_tpu_torch.pipelines.aerial:aerial_pipeline",
)
WINDOW: list = []  # the window's frame records, in order


def start() -> None:
    WINDOW.clear()
    switch = getattr(profiling, "set_tracing", None)
    if switch is not None:
        switch(True)


def _frame(args, kwargs, out) -> int:
    last = getattr(profiling, "last_frame", None)
    rec = last() if last is not None else None
    if rec is not None and (not WINDOW or WINDOW[-1] is not rec):
        WINDOW.append(rec)
    return 0


COUNTS = {key: _frame for key in ENTRIES}


def per_frame(fn) -> float | None:
    """The mean of ``fn(record)`` over the window's frames (None: none was
    recorded)."""
    if not WINDOW:
        return None
    return sum(fn(rec) for rec in WINDOW) / len(WINDOW)
