"""Mean seconds per solve of the solver's ``solve_pool`` span, the batched
QAOA (core/qaoa.py, core/engine.py). The span ends in the host's read of
the candidates, so it includes the device's work. It moves tts_s."""


def read(window, log):
    return sum(t["solve_s"] for t in window.timings) / len(window.timings)
