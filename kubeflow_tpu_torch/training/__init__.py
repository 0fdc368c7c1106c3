"""Training: the Trainer, optimizers, data and checkpoints
(``python -m kubeflow_tpu_torch.training``)."""
