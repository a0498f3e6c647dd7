"""Milliseconds a round in the aggregating step outside its gradient call
(CUDA events; compression, dither, the client mean and the FedCET
update), the mean over the window's rounds."""


def read(run):
    if not run.spans:
        return None
    return sum(r["agg_ms"] for r in run.spans) / len(run.spans)
