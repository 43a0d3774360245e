"""setup_s: process start to the window's start: imports, the card, the
weights, kernel builds where there are none yet, and the warm-up request."""


def read(run):
    return run.setup_s
