"""Data efficiency (counterpart of ``deepspeed_tpu/runtime/data_pipeline``):
curriculum scheduling, the curriculum-gated sampler, the offline analyzer
and its indexed stores, and random-LTD's schedule and token routing."""

from .curriculum_scheduler import CurriculumScheduler  # noqa: F401
from .data_sampler import DeepSpeedDataSampler  # noqa: F401
from .data_routing.random_ltd import (  # noqa: F401
    RandomLTDScheduler,
    random_ltd_gather,
    random_ltd_indices,
    random_ltd_scatter,
)
from .data_analyzer import (  # noqa: F401
    DataAnalyzer,
    IndexedMetricStore,
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    build_metric_to_sample,
    seqlen_metric,
)
