"""paddle_tpu_torch.observability — always-on runtime telemetry
(counterpart of ``paddle_tpu/observability``: the same series, spans,
exporters and file formats, so the reference's readers read the port's
telemetry).

    import paddle_tpu_torch.observability as obs

    obs.configure(jsonl_path="telemetry.jsonl")   # or env
    reqs = obs.counter("serving.requests")
    reqs.inc(reason="admitted")                   # labeled series
    obs.histogram("serving.ttft_seconds").observe(0.031)
    print(obs.PrometheusExporter().render())

    with obs.span("myapp.handle", request_id="r1") as sp:
        sp.event("admitted")                      # structured tracing:
        ...                                       # spans + flight
    obs.flight_dump(reason="debug")               # recorder (tracing.py)

    obs.enabled(False)    # every record becomes an early-return and
                          # jit_callback copies nothing off the device

Instrumented: inference.ContinuousBatchingPredictor (queue depth, page
utilization, TTFT / per-token latency, admissions / evictions /
rejections, prefix-cache, chunked-prefill and speculative counters, the
``serve.generate`` / ``serve.request`` / ``serve.prefill`` spans, a
flight dump on a decode-watchdog trip), the AOT engine and builder
(``aot.*``), the KV pool's page evictions, the fault registry
(``robustness.faults_injected``), the fused optimizer's dispatch counter
and the Trainer loop (step-phase spans, loss and goodput gauges, anomaly
counter, per-rank heartbeat). Every recording site is host code around
a device step, never inside a captured CUDA graph. The reference's
cross-rank ``fleet.py`` is not ported.
"""
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, Sample, DEFAULT_BUCKETS,
    enabled, scoped, get_registry, counter, gauge, histogram,
)
from .exporters import (  # noqa: F401
    JsonlExporter, PrometheusExporter, TensorBoardExporter,
)
from .runtime import (  # noqa: F401
    jit_callback, device_memory_stats, configure, maybe_export,
    export_record, telemetry_path, RankHeartbeat, rank_identity,
    set_identity, export_identity,
)
from .slo import (  # noqa: F401
    Ewma, SLOSpec, SLOEngine, default_serving_slos,
)
from .tracing import (  # noqa: F401
    Span, TraceContext, NULL_SPAN, span, start_span, traced,
    current_span, FlightRecorder, flight_recorder, flight_dump,
    flight_dir, set_flight_dir, to_chrome_trace, write_chrome_trace,
)
from .critpath import (  # noqa: F401
    stage_decomposition, trace_tree,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "Sample",
    "DEFAULT_BUCKETS", "enabled", "scoped", "get_registry", "counter",
    "gauge", "histogram", "JsonlExporter", "PrometheusExporter",
    "TensorBoardExporter", "jit_callback", "device_memory_stats",
    "configure", "maybe_export", "export_record", "telemetry_path",
    "RankHeartbeat", "rank_identity", "set_identity", "export_identity",
    "Ewma", "SLOSpec", "SLOEngine", "default_serving_slos",
    "Span", "TraceContext", "NULL_SPAN", "span", "start_span",
    "traced", "current_span", "FlightRecorder", "flight_recorder",
    "flight_dump", "flight_dir", "set_flight_dir", "to_chrome_trace",
    "write_chrome_trace", "stage_decomposition", "trace_tree",
]
