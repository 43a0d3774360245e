"""tokens_per_s: prompt and generated tokens of every request in the
window, over the window's time (the first request's start to the last
one's end, on the host's clock around work ending in a synchronise)."""
from portbench.traffic import tokens_per_request


def read(run):
    w = run.window
    return w["requests"] * tokens_per_request(run.mix) / w["seconds"]
