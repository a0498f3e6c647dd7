"""The FedCET kernels' share of their memory roofline, in percent: the
bytes the profiled rounds' FedCET update needs (``fedbench/counts.py``)
over the card's memory bandwidth, divided by the summed device time of
the kernels that did it (``torch.profiler``)."""

from fedbench import counts

#: the FedCET update's kernels, by a part of their name
KERNELS = ("fedcet_v_kernel", "fedcet_comm_kernel", "round_tail_kernel")


def read(run):
    if not run.trace:
        return None
    seconds = sum(s for name, s in run.trace["kernels"]
                  if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    need = counts.fedcet_update_bytes(run.n_params, run.mix) \
        * run.profiled_rounds
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / seconds
