"""PyTorch/CUDA port of kubeflow_tpu's compute path, for one NVIDIA H100.

Beside ``kubeflow_tpu`` (the JAX reference) and independent of it: this
package imports ``torch`` and never ``jax`` nor anything from
``kubeflow_tpu``.  Module names mirror the reference so each counterpart
is easy to find (``ops/flash_attention.py`` <-> ``ops/flash_attention.py``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`kubeflow_tpu_torch.device`).
"""
