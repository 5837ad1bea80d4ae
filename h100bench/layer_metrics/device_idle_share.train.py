"""The device's idle share in the train entry's profiled stretch: one minus
the union of the device operations' intervals over the stretch's wall
length (from a synchronised start to a synchronised end)."""


def read(ctx):
    st = ctx.get("stretch")
    if ctx["entry"] != "train" or st is None or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
