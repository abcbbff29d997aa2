"""``eval_ms_p95``: the 95th percentile of the evaluator's spans, one a
dispatch (linear interpolation, numpy's default)."""
import numpy as np


def read(ctx):
    if not ctx["eval_s"]:
        return None
    return float(np.percentile(np.asarray(ctx["eval_s"]), 95)) * 1e3
