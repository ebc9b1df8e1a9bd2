"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over set-up and the
window, read when the window closes, in GiB."""


def read(r):
    b = r.res["peak_bytes"]
    return b / 2 ** 30 if b else None
