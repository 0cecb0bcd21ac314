"""Mean seconds per solve of the batched QAOA's work outside its Adam steps,
on the device: the cost table, the final evolution with ⟨C⟩, and the top-K
of the marginals, from the solver's ``cost_table``, ``final_state`` and
``top_k`` spans (each solve's ``qaoa_tail_s`` timing). None where the solver
records no such span. It moves tts_s."""


def read(window, log):
    tails = [t["qaoa_tail_s"] for t in window.timings if "qaoa_tail_s" in t]
    return sum(tails) / len(tails) if tails else None
