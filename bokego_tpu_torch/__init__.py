"""bokego_tpu_torch — the PyTorch/CUDA port of bokego_tpu for NVIDIA Hopper.

The package mirrors ``bokego_tpu``'s module layout (``env``, ``features``,
``models``, ``search``, ``ops``, ``parallel``) so each module's counterpart
is easy to find.  It imports ``torch`` and ``numpy`` only: never ``jax``,
and nothing from ``bokego_tpu`` (whose ``__init__`` imports jax when
``JAX_PLATFORMS=cpu``), so the host-side tables it needs are copied here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of silently running on the CPU
(:func:`bokego_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

from bokego_tpu_torch.coords import BLACK, EMPTY, NN, N, PASS_ACTION, WHITE

__all__ = ["N", "NN", "PASS_ACTION", "EMPTY", "BLACK", "WHITE"]
