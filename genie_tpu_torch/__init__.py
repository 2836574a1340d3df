"""genie_tpu_torch — the PyTorch/CUDA port of ``genie_tpu``.

The JAX package ``genie_tpu`` stays the reference; this package mirrors its
module names (``models/detector.py`` ↔ ``models/detector.py`` …) so each
counterpart is easy to find. It imports ``torch``, ``numpy`` and ``scipy``
only: never ``jax``, ``flax``, ``optax`` or any ``genie_tpu`` module. The few
pure-numpy host modules it needs are copied in.

Entry points take an explicit ``device``. It defaults to ``cuda``; without a
GPU the caller must pass ``device="cpu"`` (see :func:`resolve_device`).
Every hand-written kernel lives under ``ops/`` beside its plain PyTorch
version; its CUDA source is under ``csrc/`` and is compiled by ``nvcc`` at
first use (``ops/_build.py``).
"""

__version__ = "0.1.0"

from genie_tpu_torch.config import Config, load_config  # noqa: F401
from genie_tpu_torch.device import resolve_device  # noqa: F401
