"""mfu.lm_round: model FLOPs an FL round of transformer clients (counted
from shapes in `perfbench/counts/`: no recomputation, no unrouted
expert, no elementwise work) over the wall seconds a round of the run's
untraced window, as a share of the card's peak in the precision the
configuration states.  Silent without a device trace."""


def read(ctx):
    if ctx["unit"] != "lm_round":
        return None
    layer, tr = ctx["layer"], ctx["trace"]
    if not layer.get("model_flops") or tr.busy_s <= 0.0:
        return None
    per_unit_s = ctx["untraced"]["window_s"] / ctx["untraced"]["units"]
    return 100.0 * layer["model_flops"] / ctx["units"] / per_unit_s \
        / layer["peak_flops"]
