"""Stream-method registration: operator modules attach their sugar to
:class:`Stream` at import time (the reference's extension-trait methods).
A copy of ``dbsp_tpu/operators/registry.py``."""

from dbsp_tpu_torch.circuit.builder import CircuitError, Stream


def stream_method(fn):
    if hasattr(Stream, fn.__name__):
        raise CircuitError(f"Stream.{fn.__name__} registered twice")
    setattr(Stream, fn.__name__, fn)
    return fn


def require_schema(stream: Stream, who: str):
    """Typed check for the sugar's schema metadata (survives ``-O``)."""
    schema = getattr(stream, "schema", None)
    if schema is None:
        raise CircuitError(
            f"{who} needs stream schema metadata on {stream!r}; build the "
            "stream through the operator sugar (add_input_zset/map_rows/"
            "index_by) or set .schema = (key_dtypes, val_dtypes)")
    return schema
