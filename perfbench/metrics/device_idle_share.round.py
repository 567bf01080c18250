"""device_idle_share.round: the share of a round's wall time (the run's
untraced window) in which no kernel, copy or fill ran on the card: the
profiler's device intervals, merged, over the traced window's rounds.
(The traced window's own idle share, `busy_s` against `window_s`,
also counts the profiler's host overhead.)"""


def read(ctx):
    if ctx["unit"] != "round":
        return None
    tr = ctx["trace"]
    if tr.busy_s <= 0.0:
        return None
    busy = tr.busy_s / ctx["units"]
    wall = ctx["untraced"]["window_s"] / ctx["untraced"]["units"]
    return 100.0 * (1.0 - busy / wall)
