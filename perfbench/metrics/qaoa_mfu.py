"""The QAOA stage's share of the chips' peak, in %: the least time the
stage's work could take on one card (counts/qaoa_stage.py, at the cell's
rows, qubits, layers and Adam steps) over the measured ``solve_pool``
span, summed over the window's solves, times the cards that share the
rows. It moves tts_s."""

from perfbench.counts import qaoa_stage
from perfbench.lib import peaks


def read(window, log):
    c = window.config
    least = peaks.least_s(*qaoa_stage.work(window.rows, c["n_qubits"], c["p_layers"],
                                           c["opt_steps"]))
    spent = sum(t["solve_s"] for t in window.timings)
    return 100.0 * least * len(window.timings) / (window.chips * spent)
