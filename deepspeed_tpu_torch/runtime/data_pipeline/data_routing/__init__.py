from .random_ltd import (  # noqa: F401
    RandomLTDScheduler,
    random_ltd_gather,
    random_ltd_indices,
    random_ltd_layer,
    random_ltd_scatter,
)
