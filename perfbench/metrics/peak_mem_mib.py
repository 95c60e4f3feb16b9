"""``torch.cuda.max_memory_allocated`` over the measured window (MiB),
read by the benchmark from the card's allocator."""


def read(r):
    return r.peak_bytes / 2 ** 20 if r.peak_bytes else None
