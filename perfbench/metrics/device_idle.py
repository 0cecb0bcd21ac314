"""The share of the traced window in which no operation ran on the device,
from torch.profiler's trace (a fraction). It moves tts_s."""


def read(window, log):
    if window.trace is None:
        return None
    return 1.0 - window.trace.busy_s / window.trace.window_s
