"""``scan_roofline``: the floor of the SRU recurrences the real candidates
need (``scan_cost``'s formula; bytes bound it) over the device time of the
``sru_scan_pop`` kernels."""
from yardstick import roofline_share


def read(ctx):
    return roofline_share(ctx, "scan", "sru_scan_pop")
