"""Share of the traced serving window in which no operation ran on the card."""
from gpubench.tracing import idle_share


def read(cell, summary):
    return idle_share(summary)
