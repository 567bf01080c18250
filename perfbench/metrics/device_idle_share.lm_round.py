"""device_idle_share.lm_round: the share of an FL round of transformer
clients (its wall time in the run's untraced window) in which no kernel,
copy or fill ran on the card: the profiler's device intervals, merged,
over the traced window's rounds."""


def read(ctx):
    if ctx["unit"] != "lm_round":
        return None
    tr = ctx["trace"]
    if tr.busy_s <= 0.0:
        return None
    busy = tr.busy_s / ctx["units"]
    wall = ctx["untraced"]["window_s"] / ctx["untraced"]["units"]
    return 100.0 * (1.0 - busy / wall)
