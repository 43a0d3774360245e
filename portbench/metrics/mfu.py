"""mfu: model FLOPs of the window's requests (the architecture's own count
from the configuration's widths, ``arch/<arch>.py`` ``request_flops``) over
the window's time, as a share of the card's bf16 peak, in %."""
from portbench.yardstick import PEAK_BF16_FLOPS


def read(run):
    if run.device == "cpu":
        return None
    mix, w = run.mix, run.window
    flops = w["requests"] * run.arch.request_flops(run.config, mix["batch"], mix["prompt_tokens"],
                                                   mix["max_new_tokens"])
    return 100.0 * flops / w["seconds"] / PEAK_BF16_FLOPS
