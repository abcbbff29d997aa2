"""``device_ops_per_gen``: operations on the device (kernels, copies,
fills) in the ``torch.profiler`` trace of the window, whatever issued them,
a generation."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["gens"]:
        return None
    return len(tr["ops"]) / ctx["gens"]
