"""local_train_ms.round: device milliseconds a round of the work inside
the program's ``fed_step/local_train`` scope (`core/engine.py`, open
when telemetry is on, as in the traced run)."""


def read(ctx):
    if ctx["unit"] != "round" or not ctx["layer"].get("scope"):
        return None
    s = ctx["trace"].scope_s(ctx["layer"]["scope"])
    if s is None:
        return None
    return 1e3 * s / ctx["units"]
