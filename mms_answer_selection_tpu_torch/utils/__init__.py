from . import fillers  # noqa: F401
