"""Seed users of the train steps completed in the window, over the window's
seconds (host clock; the window ends in a synchronise)."""


def read(record):
    return record["window"]["units"] / record["window_s"]
