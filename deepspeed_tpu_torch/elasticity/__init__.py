"""Elastic training (counterpart of ``deepspeed_tpu/elasticity``): the
compatible-batch math (:mod:`.elasticity`) and the supervisor that relaunches
the workers at a new world size from the newest committed tag
(:mod:`.elastic_agent`)."""

from .elasticity import (  # noqa: F401
    ELASTICITY_CONFIG_ENV,
    ElasticityError,
    compute_elastic_config,
    elastic_ladder,
    elasticity_enabled,
    ensure_immutable_elastic_config,
    get_candidate_batch_sizes,
    get_valid_gpus,
    get_valid_world_sizes,
    validate_elasticity_block,
    world_bounds,
)
