"""Trained tokens per second: every token that every client trained on in
the window's completed rounds, over the host-clock time from the window's
start to the last round's synchronize."""


def read(run):
    if not run.rounds:
        return None
    return run.tokens / run.window_s
