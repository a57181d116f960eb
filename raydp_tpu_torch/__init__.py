"""PyTorch/CUDA port of ``raydp_tpu`` for NVIDIA Hopper.

The package mirrors ``raydp_tpu``'s layout (``ops``, ``models``, ``parallel``,
``serve``, ``estimator``, ``exchange``, ``obs``) module for module, so each
counterpart sits at the same path. It imports ``torch`` and numpy only:
nothing of JAX and nothing of ``raydp_tpu``.
Every kernel that the JAX package wrote in Pallas is written here by hand in
CUDA C++ for ``sm_90a`` (``csrc/``), built at first use and bound with
``ctypes`` (``ops/_build.py``); beside each kernel sits a plain PyTorch
version that runs only for CPU tensors.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise
(``raydp_tpu_torch._device.resolve_device``).

Ported so far, in three slices:

1. decode serving of ``TransformerLM`` (``serve.decode``, ``serve.kvcache``);
2. training of ``TransformerLM`` (the flash backward, ``remat``);
3. DLRM training through the estimator on one card
   (``estimator.Estimator`` with ``models.dlrm.DLRM``, ``models.mlp``,
   ``optim`` and the dot-interaction kernel), staging from numpy through
   ``exchange.dataset.ArrayDataset`` until the port has its store.
"""

from raydp_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
