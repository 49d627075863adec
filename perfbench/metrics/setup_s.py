"""Seconds from the process's start to the window's: interpreter, CUDA,
the kernel library built or loaded, the traffic made, the warm-up."""


def read(run):
    return run["setup_s"]
