from repro_torch.serving.engine import (  # noqa: F401
    cache_shapes,
    greedy_sample,
    make_decode_step,
    make_prefill_step,
)
