"""``host_ms``: mean milliseconds a generation spent outside the evaluator
(the search driver on the host: NSGA-II, the problem's screen and memo, the
hardware objectives), from the harness's spans around
``target.val_error_batch``."""


def read(ctx):
    if not ctx["gens"]:
        return None
    return (ctx["window_s"] - sum(ctx["eval_s"])) / ctx["gens"] * 1e3
