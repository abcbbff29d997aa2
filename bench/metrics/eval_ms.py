"""``eval_ms``: mean milliseconds a generation spent inside the evaluator
(``target.val_error_batch``, which ends in a host read of the counts, so the
span is synchronised); a generation whose genomes were all cached counts 0."""


def read(ctx):
    if not ctx["gens"]:
        return None
    return sum(ctx["eval_s"]) / ctx["gens"] * 1e3
