"""The process's peak of allocated device memory
(``torch.cuda.max_memory_allocated``), set-up and window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
