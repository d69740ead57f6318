"""The scheduler-extender seam on the port: the sidecar server
(server.py) and the scheduler-side HTTP client (client.py)."""

from kubernetes_tpu_torch.extender.server import ExtenderServer
