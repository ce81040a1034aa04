"""Version stamping (reference src/version.cc; counterpart of
``slate_tpu/version.py``). The port carries the JAX package's version
number and names itself in :func:`id`."""

__version__ = "0.1.0"


def version() -> str:
    return __version__


def id() -> str:  # noqa: A001 - mirrors slate::id()
    return "slate_tpu_torch-" + __version__
