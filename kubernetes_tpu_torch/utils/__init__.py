"""Logging, metrics and tracing (copies of the JAX package's utils/ with the
imports rewritten)."""

from kubernetes_tpu_torch.utils.trace import (
    Span,
    Trace,
    chrome_trace,
    current_trace_id,
    current_traceparent,
    format_traceparent,
    parse_traceparent,
    use_traceparent,
)
from kubernetes_tpu_torch.utils.metrics import Histogram, Counter, Gauge, REGISTRY
