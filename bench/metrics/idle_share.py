"""``idle_share``: percent of the traced window in which no operation ran on
the device."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["traced_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["traced_s"]) * 100.0
