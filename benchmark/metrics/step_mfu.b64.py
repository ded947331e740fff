"""The model step's share of the card's peak: K1's and K2's operations over
the window at 989 TFLOP/s bf16, in %."""

from readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run, batched=True)
