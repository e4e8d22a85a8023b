"""AOT inference engine (counterpart of ``paddle_tpu/inference/aot``):
calibrate and capture every serve program of ``ContinuousBatchingPredictor``
into a bundle, then warm-start with every program replayed as a CUDA
graph and nothing traced or built on the hot path.

    from paddle_tpu_torch.inference import aot

    # offline (once per model, geometry and runtime):
    aot.build_engine(model, "engine/", prompt_buckets=(16, 32),
                     max_batch_size=4, page_size=16, max_seq_len=512)

    # at serving startup (every restart):
    predictor, engine = aot.warm_start(model, "engine/")
    predictor.generate(prompts)

A bucket miss runs its step eagerly once, captures it and writes its
signature back into the bundle; a corrupted or mismatched bundle is
rejected (``aot.counters["invalidations"]``) and rebuilt clean.
"""
from .bundle import (  # noqa: F401
    EngineBundle, BundleInvalid, runtime_fingerprint, model_fingerprint,
    sig_key, MANIFEST, FORMAT,
)
from .engine import (  # noqa: F401
    InferenceEngine, load_engine, warm_start, wire_kernel_cache,
    default_engine_dir, counters, reset_counters, COMPILED_GEOMETRY_KEYS,
)
from .builder import EngineBuilder, build_engine  # noqa: F401

__all__ = [
    "EngineBundle", "BundleInvalid", "runtime_fingerprint",
    "model_fingerprint", "sig_key", "MANIFEST", "FORMAT",
    "InferenceEngine", "load_engine", "warm_start", "wire_kernel_cache",
    "default_engine_dir", "counters", "reset_counters",
    "COMPILED_GEOMETRY_KEYS", "EngineBuilder", "build_engine",
]
