from .flops_profiler import (  # noqa: F401
    FlopCount,
    FlopsProfiler,
    add_kernel_flops,
    format_module_tree,
    get_model_profile,
    number_to_string,
    per_module_profile,
    profile_fn,
)
