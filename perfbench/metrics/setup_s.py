"""setup_s: from the process's start to the window's start (the loop's
request of the first window frame), the data generation included."""


def read(r):
    return r.setup_s
