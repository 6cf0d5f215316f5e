"""Span-structured tracing of the notary's head loop (the port's copy of
the JAX package's `tracing/`; its Chrome trace export waits)."""

from gethsharding_tpu_torch.tracing.tracer import (  # noqa: F401
    NOOP_SPAN,
    Span,
    TRACER,
    Tracer,
    current_context,
    disable,
    enable,
    request_context,
    span,
    tag_current,
)
