"""The port's data pipeline: its own copy of ``repro.data``'s numpy-only
``SyntheticLMData`` and ``TokenPacker`` (batches bit-identical to JAX's),
and ``as_tensors`` to move a batch onto a device."""

from .pipeline import SyntheticLMData, TokenPacker, as_tensors  # noqa: F401
