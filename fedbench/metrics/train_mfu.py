"""Model FLOPs of the window's trained tokens over the window's seconds
times the card's float32 peak (TF32 is off), in percent
(``fedbench/counts.py``, the family's ``train_flops_per_token``)."""

from fedbench import counts


def read(run):
    if not run.rounds:
        return None
    flops = counts.train_flops_per_round(run.family, run.conf, run.mix) \
        * run.rounds
    return 100.0 * flops / (run.window_s * run.peaks["fp32_flops"])
