__version__ = "0.3.0"  # the JAX package's version, whose API this mirrors


def version() -> str:
    return __version__
