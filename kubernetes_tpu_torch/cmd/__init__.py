"""Component entry points of the port: `python -m
kubernetes_tpu_torch.cmd.<component>`, sharing the flag/config/signal
plumbing in `kubernetes_tpu_torch.cmd.base`."""
