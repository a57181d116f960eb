"""PyTorch/CUDA port of ``raydp_tpu`` for NVIDIA Hopper.

The package mirrors ``raydp_tpu``'s layout (``ops``, ``models``, ``parallel``,
``serve``, ``estimator``, ``exchange``, ``obs``, ``cluster``) module for
module, so each counterpart sits at the same path. It imports ``torch``,
numpy, cloudpickle and the stdlib only: nothing of JAX and nothing of
``raydp_tpu``.
Every kernel that the JAX package wrote in Pallas is written here by hand in
CUDA C++ for ``sm_90a`` (``csrc/``), built at first use and bound with
``ctypes`` (``ops/_build.py``); beside each kernel sits a plain PyTorch
version that runs only for CPU tensors.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise
(``raydp_tpu_torch._device.resolve_device``, imported lazily: the cluster's
head, agents and zygote import this package without torch).

Ported so far:

1. decode serving of ``TransformerLM`` (``serve.decode``, ``serve.kvcache``);
2. training of ``TransformerLM`` (the flash backward, ``remat``);
3. DLRM training through the estimator on one card
   (``estimator.Estimator`` with ``models.dlrm.DLRM``, ``models.mlp``,
   ``optim`` and the dot-interaction kernel), staging from numpy through
   ``exchange.dataset.ArrayDataset`` until the port has its store;
4. the int8 path (stochastic rounding, the int8 product);
5. the estimator's streamed, checkpointed and retried fit, and ``obs``;
6. the decode engine's obs;
7. the cluster runtime (``cluster``: head, actor workers, zygote, node
   agents, the client API) with obs shipped to the head, and the lockdep
   and leak sanitizers (``sanitize``).
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # lazy: resolve_device imports torch, and the cluster's head, agents and
    # zygote import modules of this package without needing torch
    if name == "resolve_device":
        from raydp_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
