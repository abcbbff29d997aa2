"""``gen_mfu``: the model FLOPs the real candidates' forwards need (2 x the
configuration's MxV weights a frame or token, each lane, each dispatch) over
the window's seconds at the H100's float32 peak: every MxV of the kernel
lane computes in exact float32 outside the tensor cores. It is read in the
traced run, whose profiler slows a launch-bound cell's window (the xLSTM's
by ~15 %): a share of that window, below an untraced run's."""
from yardstick import PEAK_F32_FLOPS


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    flops = sum(ctx["work"](n)["model_flops"] for n in ctx["eval_sizes"])
    if flops <= 0:
        return None
    return flops / (ctx["window_s"] * PEAK_F32_FLOPS) * 100.0
