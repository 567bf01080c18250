"""stage1_roofline.lm_round: the stage-1 aggregations' least time (each
one's bytes read and written once at the HBM peak, `counts/stage1.py`)
over the device time of the ``wagg_grouped*`` kernels
(`csrc/weighted_agg.cu`) in the traced window."""


def read(ctx):
    if ctx["unit"] != "lm_round":
        return None
    layer = ctx["layer"]
    spent = ctx["trace"].kernel_s(lambda n: "wagg_grouped" in n)
    if spent <= 0.0 or not layer.get("stage1_calls"):
        return None
    return 100.0 * layer["stage1_calls"] * layer["stage1_bound_s"] / spent
