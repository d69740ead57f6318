"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

A second package beside the JAX reference (`kubernetes_tpu/`), with the same
module layout so each counterpart is found by path.  It imports torch and
numpy, never jax and nothing of the JAX package: the JAX-free modules it
needs (api/, codec/interner.py, codec/encoder.py) are kept as its own copies.

  api/      object model, quantities, label selectors, object factory
  codec/    tensor schema, snapshot encoder, host<->device transfer
  ops/      Filter (predicates), Score (priorities), host selection
  kernels/  hand-written CUDA kernels, built from source at first use
  models/   the sequential and speculative engines
  loop.py   the raw scheduling loop (bench.py run()'s timed section)

Entry points run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
