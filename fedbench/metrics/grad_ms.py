"""Milliseconds a round in the vmapped client-gradient calls (CUDA
events), the mean over the window's rounds."""


def read(run):
    if not run.spans:
        return None
    return sum(r["grad_ms"] for r in run.spans) / len(run.spans)
