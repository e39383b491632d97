"""Seconds from process start to the window's opening."""


def read(m):
    return m["setup_s"]
