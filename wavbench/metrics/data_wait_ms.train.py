"""Host time a train step waited for its batch from the prefetch thread, as
``train/loop.run_loop`` measures it (the host clock around ``next()``),
over the window's steps."""


def read(record):
    if record.get("driver") != "train" or not record["steps"]:
        return None
    return 1000.0 * record["data_wait_s"] / record["steps"]
