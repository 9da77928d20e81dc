"""Host-side core of the port: Params, DataFrame, stages, serialization."""
