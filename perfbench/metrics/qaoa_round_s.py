"""Mean seconds of one round of the batched QAOA on the device (one call of
``core.qaoa.solve_batch_on_device`` on the round's rows, then its top-K),
from the solver's ``qaoa_round`` spans: each solve's ``qaoa_round_s``
timing, the mean of its rounds' device intervals. None where the solver
records no such span. It moves tts_s."""


def read(window, log):
    rounds = [t["qaoa_round_s"] for t in window.timings if "qaoa_round_s" in t]
    return sum(rounds) / len(rounds) if rounds else None
