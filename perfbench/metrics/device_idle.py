"""The share of the traced window in which no operation ran on the device,
from torch.profiler's trace (a fraction): over cards, the mean of each
card's idle share of its own window. It moves tts_s."""


def read(window, log):
    cards = window.cards
    if not cards or cards[0].trace is None:
        return None
    return 1.0 - sum(c.trace.busy_s / c.trace.window_s for c in cards) / len(cards)
