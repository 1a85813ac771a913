"""The run's peak of device memory allocated, in GiB: the process's
``torch.cuda.max_memory_allocated`` after the window (the resident nets,
their graphs' pool, and the largest set-up and frame temporaries). None
off the card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
