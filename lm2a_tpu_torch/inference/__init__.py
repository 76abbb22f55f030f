from lm2a_tpu_torch.inference.longform import (
    crossfade_stitch,
    generate_long,
    generate_single_pass,
    window_conditions,
    with_streaming_attention,
)
from lm2a_tpu_torch.inference.sample import (
    FALLBACK_MEL_MEAN,
    FALLBACK_MEL_STD,
    LoadedModels,
    compute_batch_from_npz,
    compute_single_from_npz,
    generate_mel,
    generate_mel_batch,
    load_models,
    sample_batch_from_npz,
    sample_from_npz,
    write_clip_outputs,
)

__all__ = [
    "crossfade_stitch",
    "generate_long",
    "generate_single_pass",
    "with_streaming_attention",
    "window_conditions",
    "FALLBACK_MEL_MEAN",
    "FALLBACK_MEL_STD",
    "LoadedModels",
    "compute_batch_from_npz",
    "compute_single_from_npz",
    "write_clip_outputs",
    "generate_mel",
    "generate_mel_batch",
    "sample_batch_from_npz",
    "load_models",
    "sample_from_npz",
]
