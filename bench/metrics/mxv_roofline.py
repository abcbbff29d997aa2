"""``mxv_roofline``: the floor of the MxV work the real candidates need
(``bank_mxv_cost``'s formula on the configuration's shapes, padding lanes
not counted) over the device time of the ``bank_mxv_pop`` kernels."""
from yardstick import roofline_share


def read(ctx):
    return roofline_share(ctx, "mxv", "bank_mxv_pop")
