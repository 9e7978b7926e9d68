"""The most device memory allocated at once over set-up, the window and
the traced trials (``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
