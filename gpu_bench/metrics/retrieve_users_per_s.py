"""Users the retrieval server answered in the window, over the window's
seconds (host clock)."""


def read(record):
    return record["window"]["users_answered"] / record["window_s"]
