"""setup_s: seconds from the process's start to the window's: imports,
inputs made from the seed, the program's set-up, builds, warm-up and the
first steps (host clock)."""


def read(record):
    return record["setup_s"]
