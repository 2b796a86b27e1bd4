"""Runtime services of the port: gradient compression with error feedback
(``compression``) and straggler detection (``straggler``), as in
``repro.runtime``.  Parameter placement on a device mesh (JAX's
``runtime/sharding.py``, ``runtime/elastic.py``) waits for the model's
mesh paths (ROADMAP queue 1, item 14b.3)."""

from .compression import (  # noqa: F401
    CompressedAllReduce,
    bf16_compress,
    bf16_decompress,
    int8_compress,
    int8_decompress,
)
from .straggler import StragglerMonitor  # noqa: F401
