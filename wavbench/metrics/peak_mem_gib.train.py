"""The most device memory PyTorch's allocator held in the train window
(``max_memory_allocated`` after a reset at the window's start)."""


def read(record):
    if record.get("driver") != "train" or not record.get("peak_window_bytes"):
        return None
    return record["peak_window_bytes"] / 2**30
