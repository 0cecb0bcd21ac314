"""Mean seconds of one Adam step of the batched QAOA on the device (forward,
adjoint backward and Adam update of every row), from the solver's
``adam_step`` spans: each solve's ``adam_step_s`` timing, the mean of its
steps' device intervals. None where the solver records no such span. It
moves tts_s."""


def read(window, log):
    steps = [t["adam_step_s"] for t in window.timings if "adam_step_s" in t]
    return sum(steps) / len(steps) if steps else None
