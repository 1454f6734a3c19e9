from .checkpointing import (  # noqa: F401
    CheckpointConfig,
    RNGStatesTracker,
    checkpoint,
    checkpoint_wrapper,
    configure,
    get_rng_tracker,
    is_configured,
    model_parallel_reseed,
    policy_from_config,
    reset,
)
