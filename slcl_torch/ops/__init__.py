from . import centroids, losses  # noqa: F401
